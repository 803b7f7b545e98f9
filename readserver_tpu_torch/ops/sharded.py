"""The interval-sharded index's device functions: rank (K9), lookups and
walks (K10) and the prefix-LUT level (K11), over a ``ShardedIndex``
(``parallel/sharded.py``) whose S shards all live on one device.

Each function has two forms:

* a plain torch form (``*_plain``), the JAX package's masked-contribution
  form literally: every shard computes a clamped local value and the S
  values are summed in int64 (a rank, where the shards below the position
  add their totals) or at most one of them is nonzero (a lookup, clipped
  to the shard's last entry and masked);
* kernels ``csrc/sharded.cu`` (K9 ``rs_shard_occ``, the search
  ``rs_sharded_search``, K11 ``rs_sharded_lut_level`` and K10
  ``rs_sharded_resolve``), where each position has one owner: a lane
  finds the shard holding its position among the shards' starts and
  reads one row there, ``rank(c, i) = prefix[s][c] + occ_s(c, i -
  start_s)``, or the owning shard's chunk for a lookup, 0 where no shard
  owns the key.  The same integers as the clamped sums.  The search is
  K2's body (``csrc/search.cuh``) and K10's walks and sweep are the
  single-device persistent sweep (``csrc/walk.cuh``), each over this
  owner accessor.

The partials (K9's partial ``occ_partial`` and ``step_partial``, K13
``lookup_partial``, K11's partial ``lut_level_partial``, and the walk steps
``lf_walk_step`` and ``slow_walk_step``, ``csrc/sharded_partial.cu``) serve
an index whose shards are spread over the ranks of a process group: each
takes the view of one rank's run of shards and gives the JAX masked
contribution summed over that run only, at the JAX psum's width, which the
ranks sum by one all-reduce (``parallel/sharded.py``).  A walk step also
advances the walk's state (``WalkState``, on the index's device) from the
previous all-reduce's output, so a walk is one launch and one all-reduce a
step.  Their plain forms are built on the plain forms above applied to the
run (``occ_plain`` is K9's partial's).

The public functions take the plain form for CPU tensors and launch the
kernel for CUDA tensors, with no fallback between them.  The walks are the
JAX package's ``do_walk`` routes: the dsa gather when ``dsa_chunk`` ships,
the sampled-LF walk with its terminal when the fast tier does, else the
slow walk that carries the $-rank and looks the read up once.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from dataclasses import dataclass

import torch

from readserver_tpu_torch.kernels import (
    LIBRARY,
    SHARD_LOOKUP_PARTIAL,
    SHARD_OCC,
    SHARD_OCC_PARTIAL,
    SHARDED_LUT_LEVEL,
    SHARDED_LUT_LEVEL_PARTIAL,
    SHARDED_RESOLVE,
    SHARDED_SEARCH,
    WALK_LF_STEP,
    WALK_SLOW_STEP,
)
from readserver_tpu_torch.kernels.build import check_int32, on_cuda, ptr
from readserver_tpu_torch.ops.rank import _WORD, occ_rows_plain
from readserver_tpu_torch.ops.resolve import WALK_KINDS, _rounds_cap
from readserver_tpu_torch.ops.search import (
    SEARCH_MAX_K,
    _refused,
    canonical_empty,
    prefix_ids,
    raise_if_refused,
    run_kstep,
    step_code,
)

MAX_SHARDS = 64  # a run's shards the kernels take
# K9's tables, numbered as csrc/sharded.cu takes them
TABLES = {"rank": 0, "rank2": 1, "rank3": 2, "marks": 3}
# K13's lookups, numbered as csrc/sharded_partial.cu takes them; the
# width of each one's output in lanes, and its type: the JAX psum's (int32,
# but int64 for the (LF, mark rank) pair)
LOOKUPS = {"sym": 0, "dollar": 1, "sample": 2, "dsa": 3, "lf": 4,
           "lf_mark": 5, "dollar_pair": 6}
LOOKUP_WIDTH = {"lf_mark": 2, "dollar_pair": 3}
# the walk steps' modes, numbered as csrc/sharded_partial.cu takes them
WALK_MODES = {"first": 0, "step": 1, "last": 2, "rank": 3, "terminal": 4,
              "finish": 5}
# a search step's table by its width in columns
STEP_TABLES = {1: "rank", 2: "rank2", 3: "rank3"}


def _table(sidx, table: str):
    """→ (stacked table, its prefix over shards, rows per plane)."""
    if table == "rank":
        return sidx.rank_rows, sidx.sym_prefix, sidx.rows_per_symbol
    if table == "rank2":
        return sidx.rank2_rows, sidx.prefix2, sidx.rows_per_symbol
    if table == "rank3":
        return sidx.rank3_rows, sidx.prefix3, sidx.rows_per_symbol
    if table == "marks":
        t = sidx.mark_table
        return t, sidx.mark_prefix, None if t is None else t.shape[1]
    raise ValueError(f"no sharded table {table!r}")


def _ranges(starts: torch.Tensor, lens: torch.Tensor):
    return list(zip(starts.tolist(), lens.tolist()))


def walk_kind(sidx) -> str:
    """The resolve route the index's tiers give: dsa, lf or slow."""
    if sidx.dsa_chunk is not None and sidx.dsa_bits > 0:
        return "dsa"
    if sidx.has_fast_resolve:
        return "lf"
    return "slow"


# ---------------------------------------------------------------- plain forms


def occ_plain(sidx, table: str, c: torch.Tensor, i: torch.Tensor):
    """K9's plain form: Σ_s occ_s(c, clip(i - start_s, 0, len_s)) in int64.
    c int [X] (a plane of ``table``), i int64 [X] → int64 [X]."""
    t, _, rps = _table(sidx, table)
    out = torch.zeros(i.shape, dtype=torch.int64, device=i.device)
    for s, (st, ln) in enumerate(_ranges(sidx.starts, sidx.lens)):
        loc = (i - st).clamp(0, ln).to(torch.int32)
        out += occ_rows_plain(
            t[s], c, loc, rows_per_symbol=rps, log2_block=sidx.log2_block,
            words_per_block=sidx.words_per_block,
        ).to(torch.int64)
    return out


def _lookup_plain(chunk, starts, lens, x):
    """Σ_s where(x in range s, chunk[s][clip(x - start_s, 0, len_s - 1)],
    0): the masked lookup (x int64 [X])."""
    out = None
    for s, (st, ln) in enumerate(_ranges(starts, lens)):
        inr = (x >= st) & (x < st + ln)
        loc = (x - st).clamp(0, max(ln - 1, 0))
        v = chunk[s].index_select(0, loc.reshape(-1)).reshape(
            *x.shape, *chunk.shape[2:])
        mask = inr.reshape(*inr.shape, *([1] * (chunk.dim() - 2)))
        v = torch.where(mask, v, torch.zeros_like(v))
        out = v if out is None else out + v
    return out


def sym_plain(sidx, i: torch.Tensor) -> torch.Tensor:
    """BWT symbol at global positions i (int64 [X]) → int32 [X]."""
    out = torch.zeros(i.shape, dtype=torch.int64, device=i.device)
    for s, (st, ln) in enumerate(_ranges(sidx.starts, sidx.lens)):
        inr = (i >= st) & (i < st + ln)
        loc = (i - st).clamp(0, max(ln - 1, 0))
        word = sidx.sym4[s].index_select(0, loc >> 3).to(torch.int64) & _WORD
        v = (word >> ((loc & 7) << 2)) & 0xF
        out += torch.where(inr, v, torch.zeros_like(v))
    return out.to(torch.int32)


def sample_plain(sidx, rid: torch.Tensor) -> torch.Tensor:
    """Read id (int32 [X], clipped to [0, m)) → sample id int32 [X]."""
    r = rid.to(torch.int64).clamp(0, max(sidx.num_reads - 1, 0))
    return _lookup_plain(sidx.sample_chunk, sidx.rstarts, sidx.rlens, r)


def walk_plain(sidx, rows, valid, walk_early_exit: bool = False):
    """K10's walks in plain form, the JAX ``do_walk``: rows int64 [R],
    valid bool [R] → (read_id, offset) int32 [R], -1 where invalid or
    unterminated.  ``walk_early_exit`` stops once every lane is done, which
    changes no answer."""
    m = sidx.num_reads
    kind = walk_kind(sidx)
    neg = torch.full(rows.shape, -1, dtype=torch.int32, device=rows.device)
    if kind == "dsa":
        p = _lookup_plain(sidx.dsa_chunk, sidx.starts, sidx.lens, rows)
        p = p.to(torch.int64) & _WORD
        bits = sidx.dsa_bits
        rid = (p >> bits).to(torch.int32)
        off = (p & ((1 << bits) - 1)).to(torch.int32)
        return torch.where(valid, rid, neg), torch.where(valid, off, neg)
    if kind == "lf":
        cur, done = rows, ~valid
        steps = torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)
        for _ in range(max(sidx.sample_rate, 1)):
            if walk_early_exit and bool(done.all()):
                break
            raw = _lookup_plain(sidx.lf_chunk, sidx.starts, sidx.lens, cur)
            val = (raw & 0x7FFFFFFF).to(torch.int64)
            is_term = (raw < 0) | (val < m)
            step_now = ~done & ~is_term
            cur = torch.where(step_now, val, cur)
            steps = steps + step_now.to(torch.int32)
            done = done | is_term
        raw = _lookup_plain(sidx.lf_chunk, sidx.starts, sidx.lens, cur)
        slot = occ_plain(sidx, "marks", torch.zeros_like(raw), cur)
        is_marked = raw < 0
        val = (raw & 0x7FFFFFFF).to(torch.int64)
        rid_d = _lookup_plain(sidx.dollar_chunk, sidx.dstarts, sidx.dlens, val)
        pair = _lookup_plain(sidx.spairs_chunk, sidx.sstarts, sidx.slens, slot)
        read_id = torch.where(is_marked, pair[:, 0], rid_d)
        offset = torch.where(is_marked, pair[:, 1] + steps, steps)
        ok = valid & done
        return torch.where(ok, read_id, neg), torch.where(ok, offset, neg)
    # slow walk: carry the terminal $-rank, look the read id up once
    cur, done = rows, ~valid
    drank = torch.full(rows.shape, -1, dtype=torch.int64, device=rows.device)
    offset = neg.clone()
    for t in range(sidx.max_read_len):
        if walk_early_exit and bool(done.all()):
            break
        c = sym_plain(sidx, cur)
        o = occ_plain(sidx, "rank", c, cur)
        hit = (c == 0) & ~done
        drank = torch.where(hit, o, drank)
        offset = torch.where(hit, torch.full_like(offset, t), offset)
        done = done | (c == 0)
        nxt = sidx.C.index_select(0, c.to(torch.int64)) + o
        cur = torch.where(done, cur, nxt)
    rid = _lookup_plain(sidx.dollar_chunk, sidx.dstarts, sidx.dlens,
                        drank.clamp(min=0))
    ok = valid & done
    return torch.where(ok, rid, neg), torch.where(ok, offset, neg)


def resolve_plain(sidx, rows, valid, walk_early_exit: bool = False):
    """Plain form of :func:`resolve`."""
    rid, off = walk_plain(sidx, rows, valid, walk_early_exit)
    return rid, off, sample_plain(sidx, rid)


def sweep_plain(sidx, l, u, window: int, max_rows: int | None = None,
                walk_early_exit: bool = False):
    """Plain form of :func:`sweep`: the JAX exact sweep, window after
    window of the concatenated intervals."""
    B = l.shape[0]
    S = sidx.num_samples
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
        rid, _ = walk_plain(sidx, torch.where(gvalid, wrows, 0), gvalid,
                            walk_early_exit)
        seg = qc * S + sample_plain(sidx, rid).to(torch.int64)
        hist.index_add_(0, seg, gvalid.to(torch.int32))
        t += 1
    return hist.reshape(B, S), cum <= t * window


def lut_level_plain(sidx, l, u):
    """K11's plain form: [X] level-ℓ intervals → [4X] of level ℓ+1
    (c-major), empties frozen; int64."""
    X = l.shape[0]
    cc = torch.arange(1, 5, dtype=torch.int32, device=l.device)
    cc = cc.repeat_interleave(X)
    l4, u4 = l.repeat(4), u.repeat(4)
    occ2 = occ_plain(sidx, "rank", torch.cat([cc, cc]), torch.cat([l4, u4]))
    base = sidx.C.index_select(0, cc.to(torch.int64))
    alive = l4 < u4
    return (torch.where(alive, base + occ2[: 4 * X], l4),
            torch.where(alive, base + occ2[4 * X :], u4))


def step_plain(sidx, k: int, code, l, u, active):
    """One search step of ``k`` columns over the sharded tables (the
    triple, pair or base planes), plain: ``l' = starts[code] +
    rank(code, l)`` and so for ``u`` where ``active``, both ranks in one
    [2B] call (``ops/search.run_kstep``'s step)."""
    table, starts = {3: ("rank3", sidx.C3), 2: ("rank2", sidx.C2),
                     1: ("rank", sidx.C)}[k]
    B = l.shape[0]
    occ2 = occ_plain(sidx, table, torch.cat([code, code]), torch.cat([l, u]))
    base = starts.index_select(0, code.to(torch.int64))
    return (torch.where(active, base + occ2[:B], l),
            torch.where(active, base + occ2[B:], u))


def search_plain(sidx, kmers, lengths, lut, p: int, kstep: int,
                 early_exit: bool = False):
    """Plain form of :func:`search` (the JAX ``_query_body``'s search):
    int64 (l, u) [B], empties (0, 0).  Refused queries raise
    ``ValueError`` (the kernel's guard)."""
    K = kmers.shape[1]
    if lut is None:
        p = 0
    raise_if_refused(
        int(_refused(kmers, lengths if kstep == 1 else None, p).sum()), K)
    C = sidx.C
    if lut is not None:
        rows0 = lut.index_select(0, prefix_ids(kmers, p).to(torch.int64))
        l, u = rows0[:, 0], rows0[:, 1]
        last_col = K - p
    else:
        c_last = kmers[:, K - 1].to(torch.int64)
        l, u = C.index_select(0, c_last), C.index_select(0, c_last + 1)
        last_col = K - 1
    step = functools.partial(step_plain, sidx)
    if kstep >= 2:
        l, u = run_kstep(kmers, l, u, last_col, kstep, step, early_exit)
    else:
        first = K - lengths
        for j in range(last_col - 1, -1, -1):
            l, u = step(1, kmers[:, j], l, u, (j >= first) & (l < u))
    return canonical_empty(l, u)


# ------------------------------------------ one rank's partials, plain forms


def step_partial_plain(sidx, k: int, kmers, lengths, col: int, lu,
                       lead: bool):
    """K9's search step in plain form: the run's partial of one step of
    ``k`` columns from column ``col`` over the B queries ``kmers`` [B, K]
    from the reduced ``lu`` = (l, u) int64 [2B] → int64 [2B].  A lane is
    active where l < u, its codes are bases (any base-table plane for
    k = 1) and, with ``lengths``, ``col >= K - lengths``; there the
    partial ranks of the step's plane, plus ``C_k[plane]`` on the ``lead``
    rank; elsewhere (l, u) on the lead rank and 0 on the others, so the
    sum over the ranks is the next interval."""
    B, K = kmers.shape
    l, u = lu[:B], lu[B:]
    table = STEP_TABLES[k]
    starts = {1: sidx.C, 2: sidx.C2, 3: sidx.C3}[k]
    cols = kmers[:, col : col + k]
    if k == 1:
        ok = (cols[:, 0] >= 0) & (cols[:, 0] < 5)
    else:
        ok = ((cols >= 1) & (cols <= 4)).all(dim=1)
    code = torch.where(ok, step_code(kmers, col, k), torch.zeros_like(cols[:, 0]))
    active = ok & (l < u)
    if lengths is not None:
        active &= col >= K - lengths
    occ2 = occ_plain(sidx, table, torch.cat([code, code]), lu)
    zero = torch.zeros_like(l)
    base = starts.index_select(0, code.to(torch.int64)) if lead else zero
    return torch.cat([
        torch.where(active, base + occ2[:B], l if lead else zero),
        torch.where(active, base + occ2[B:], u if lead else zero),
    ])


def lookup_partial_plain(sidx, what: str, x, y=None):
    """K13 in plain form: lookup ``what`` of the keys ``x`` (int64 [X]) over
    the run's shards, 0 where none owns the key → int32 [X]: ``sym``,
    ``dollar`` ($-rank → read id), ``sample`` (read id, clipped to
    [0, m), → sample id), ``dsa`` (the uint32 word's bits), ``lf`` (the raw
    value, sign kept); ``lf_mark`` int64 [2X] (lf, then the run's partial
    mark rank) and ``dollar_pair`` int32 [3X] (the read id of $-rank x,
    then the (read id, offset) pairs of mark-rank slots ``y``), the JAX
    program's fused pairs.  Each at the width of the JAX psum."""
    if what == "sym":
        return sym_plain(sidx, x)
    if what in ("dollar", "dollar_pair"):
        out = _lookup_plain(sidx.dollar_chunk, sidx.dstarts, sidx.dlens, x)
        if what == "dollar":
            return out
        pair = _lookup_plain(sidx.spairs_chunk, sidx.sstarts, sidx.slens, y)
        return torch.cat([out, pair.reshape(-1)])
    if what == "sample":
        return sample_plain(sidx, x)
    if what == "dsa":
        return _lookup_plain(sidx.dsa_chunk, sidx.starts, sidx.lens, x)
    if what in ("lf", "lf_mark"):
        out = _lookup_plain(sidx.lf_chunk, sidx.starts, sidx.lens, x)
        if what == "lf":
            return out
        return torch.cat([out.to(torch.int64), occ_plain(sidx, "marks", torch.zeros(
            x.shape, dtype=torch.int32, device=x.device), x)])
    raise ValueError(f"no sharded lookup {what!r}")


def lut_level_partial_plain(sidx, l, u, lead: bool):
    """K11's partial in plain form: level-ℓ intervals [X] → the run's
    partial of level ℓ+1 as int64 [8X], the lower bounds c-major, then the
    upper ones; an alive interval's partial ranks plus ``C[c]`` on the
    ``lead`` rank, a frozen one's bounds on the lead rank and 0 on the
    others."""
    X = l.shape[0]
    cc = torch.arange(1, 5, dtype=torch.int32, device=l.device)
    cc = cc.repeat_interleave(X)
    l4, u4 = l.repeat(4), u.repeat(4)
    occ2 = occ_plain(sidx, "rank", torch.cat([cc, cc]), torch.cat([l4, u4]))
    zero = torch.zeros_like(l4)
    base = sidx.C.index_select(0, cc.to(torch.int64)) if lead else zero
    alive = l4 < u4
    return torch.cat([
        torch.where(alive, base + occ2[: 4 * X], l4 if lead else zero),
        torch.where(alive, base + occ2[4 * X :], u4 if lead else zero),
    ])


# ------------------------------------- the cross-rank walks' steps, plain


@dataclass(eq=False)
class WalkState:
    """One cross-rank walk's state and buffers (:func:`walk_state`), on the
    index's device, updated in place by each step: ``cur`` int64, ``done``
    bool, ``count`` int32 (the LF walk's steps taken; the slow walk's step
    at its $, -1 before); ``step32`` int32 [R] the step's partial (LF: the
    raw LF; slow: the symbol), all-reduced in place, and after ``finish``
    the sample partial; ``step64`` int64 [R] the slow walk's rank partial;
    ``term64`` int64 [2R] the LF walk's lf_mark partial and ``term32`` its
    int32 [3R] (read id, pair) partial, or the slow walk's [R] read id of
    the $-rank, each written as lanes end; ``read_id`` and ``offset``
    int32 [R] after ``finish``.  ``live``: the plain forms' report of a
    live lane; ``seq``, ``word`` and ``buffers``: the kernels'
    (:func:`walk_live`)."""

    kind: str
    lead: bool
    rows: torch.Tensor
    valid: torch.Tensor
    cur: torch.Tensor
    done: torch.Tensor
    count: torch.Tensor
    step32: torch.Tensor
    step64: torch.Tensor | None
    term64: torch.Tensor | None
    term32: torch.Tensor
    read_id: torch.Tensor
    offset: torch.Tensor
    live: bool = True
    seq: int = 0
    word: _LiveWord | None = None
    buffers: ctypes.Structure | None = None


def lf_walk_step_plain(sidx, st: WalkState, mode: str) -> None:
    """The sampled-LF walk's step ``mode`` (the JAX ``do_walk``'s fwalk,
    852-863, and its terminal, 866-875) in plain form, as
    ``rs_walk_lf_step`` does it.  ``first``: cur = rows, done = ~valid,
    steps = 0, the lf_mark partial cleared.  ``step``/``last``, on a live
    lane, from the reduced raw LF in ``step32``: an end (sign bit set or a
    value below m) marks it done and writes its lf_mark partial (the raw
    value on the lead rank, the run's mark rank where the row is sampled);
    else cur = the value and steps + 1.  ``first`` and ``step`` then write
    the run's raw LF of each live lane's cur (0 on an ended lane).
    ``terminal``, on a valid ended lane, from the reduced lf_mark: the
    $-rank's read id or the sampled pair.  ``finish``: read ids and
    offsets, -1 where invalid or unended, and the sample partial."""
    R = st.rows.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=st.rows.device)
    if mode in ("terminal", "finish"):
        ok = st.valid & st.done
        marked = st.term64[:R].to(torch.int32) < 0
        if mode == "terminal":
            val = st.term64[:R] & 0x7FFFFFFF
            rid = _lookup_plain(sidx.dollar_chunk, sidx.dstarts, sidx.dlens,
                                val)
            pair = _lookup_plain(sidx.spairs_chunk, sidx.sstarts, sidx.slens,
                                 st.term64[R:])
            st.term32[:R] = torch.where(ok & ~marked, rid, zero)
            st.term32[R:] = torch.where((ok & marked)[:, None], pair,
                                        zero).reshape(-1)
            return
        pair = st.term32[R:].reshape(R, 2)
        rid = torch.where(marked, pair[:, 0], st.term32[:R])
        off = torch.where(marked, pair[:, 1] + st.count, st.count)
        st.read_id.copy_(torch.where(ok, rid, -1))
        st.offset.copy_(torch.where(ok, off, -1))
        st.step32.copy_(sample_plain(sidx, st.read_id))
        return
    if mode == "first":
        st.cur.copy_(st.rows)
        st.done.copy_(~st.valid)
        st.count.zero_()
        st.term64.zero_()
    else:
        raw = st.step32
        val = (raw & 0x7FFFFFFF).to(torch.int64)
        end = ~st.done & ((raw < 0) | (val < sidx.num_reads))
        step = ~st.done & ~end
        st.term64[:R] = torch.where(
            end, raw.to(torch.int64) if st.lead else 0, st.term64[:R])
        mark = occ_plain(sidx, "marks", torch.zeros_like(raw), st.cur)
        st.term64[R:] = torch.where(end & (raw < 0), mark, st.term64[R:])
        st.cur.copy_(torch.where(step, val, st.cur))
        st.count += step.to(torch.int32)
        st.done |= end
    live = ~st.done
    st.live = bool(live.any())
    if mode != "last":
        st.step32.copy_(torch.where(live, _lookup_plain(
            sidx.lf_chunk, sidx.starts, sidx.lens, st.cur), zero))


def slow_walk_step_plain(sidx, st: WalkState, mode: str, t: int = 0) -> None:
    """The slow walk's step ``mode`` (the JAX ``do_walk``'s walk, 885-895,
    in two halves, and the read id of its $-rank, 898) in plain form, as
    ``rs_walk_slow_step`` does it.  ``first``: cur = rows, done = ~valid,
    offset = -1, the $'s read-id partial cleared.  ``rank`` (step t's second
    half), from the reduced symbol c in ``step32``: the run's partial rank
    of c before cur on each live lane.  ``step``/``last`` (step t's first
    half), from the reduced c and rank o of a live lane: c = $ ends it
    (offset = t, and the run's read id of $-rank o written now), else cur
    = C[c] + o.  ``first`` and ``step`` then write the run's symbol at each
    live lane's cur (0 on an ended lane).  ``finish``: read ids and
    offsets, -1 where invalid or unended, and the sample partial."""
    zero = torch.zeros((), dtype=torch.int32, device=st.rows.device)
    if mode == "finish":
        ok = st.valid & st.done
        st.read_id.copy_(torch.where(ok, st.term32, -1))
        st.offset.copy_(torch.where(ok, st.count, -1))
        st.step32.copy_(sample_plain(sidx, st.read_id))
        return
    if mode == "rank":
        st.step64.copy_(torch.where(st.done, 0, occ_plain(
            sidx, "rank", st.step32, st.cur)))
        return
    if mode == "first":
        st.cur.copy_(st.rows)
        st.done.copy_(~st.valid)
        st.count.fill_(-1)
        st.term32.zero_()
    else:
        c, o = st.step32, st.step64
        end = ~st.done & (c == 0)
        st.count.copy_(torch.where(end, t, st.count))
        st.term32.copy_(torch.where(end, _lookup_plain(
            sidx.dollar_chunk, sidx.dstarts, sidx.dlens, o), st.term32))
        nxt = sidx.C.index_select(0, c.to(torch.int64)) + o
        st.cur.copy_(torch.where(~st.done & ~end, nxt, st.cur))
        st.done |= end
    live = ~st.done
    st.live = bool(live.any())
    if mode != "last":
        st.step32.copy_(torch.where(live, sym_plain(sidx, st.cur), zero))


# ----------------------------------------------------------------- kernels


# The owner view every entry point of csrc/sharded.cu takes (struct
# ShardView there, in this order): every field 8 bytes, a pointer as an
# integer address, 0 for a missing table.
_VIEW_FIELDS = (
    "S", "n", "num_reads", "log2_block", "words_per_block", "row_words",
    "rows_per_symbol", "sample_rate", "max_read_len", "dsa_bits",
    "starts", "lens", "C", "C2", "C3",
    "rank", "rank_stride", "rank_prefix",
    "rank2", "rank2_stride", "rank2_prefix",
    "rank3", "rank3_stride", "rank3_prefix",
    "sym4", "sym4_stride",
    "dollar", "dollar_stride", "dstarts", "dlens",
    "sample", "sample_stride", "rstarts", "rlens",
    "dsa", "dsa_stride",
    "lf", "lf_stride",
    "marks", "marks_stride", "mark_prefix",
    "spairs", "spairs_stride", "sstarts", "slens",
)


class ShardView(ctypes.Structure):
    _fields_ = [(name, ctypes.c_longlong) for name in _VIEW_FIELDS]


def _check64(name: str, t, dev, shape=None) -> None:
    if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous int64 tensor on {dev}, got "
            f"{t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check_stack(name: str, t, dev, S: int, row_words: int | None = None):
    """A stacked int32 table [S, ...]: contiguous on ``dev``; a rank table
    [S, rows, row_words] with every shard's rows 16-byte aligned when
    ``row_words == 4`` (the kernels' vector load)."""
    check_int32(name, t, dev)
    if t.shape[0] != S:
        raise ValueError(f"{name} must stack {S} shards, got {tuple(t.shape)}")
    if row_words is not None:
        if t.dim() != 3 or t.shape[2] != row_words:
            raise ValueError(
                f"{name} must be [S, rows, {row_words}], got {tuple(t.shape)}")
        if row_words == 4 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


class RunKeys(ctypes.Structure):
    """The run's key boundaries, ``csrc/sharded_partial.cu``'s RunKeys,
    passed to its kernels as a parameter: shard s of the run holds [b[s],
    b[s + 1]) of each kind of key (positions, $-ranks, read ids, mark-rank
    slots; zeros where the index has no fast tier)."""

    _fields_ = [("S", ctypes.c_longlong),
                *[(k, ctypes.c_longlong * (MAX_SHARDS + 1))
                  for k in ("pos", "dol", "rid", "slot")]]


class _LiveWord:
    """One walk's live flag: a device word (the last sequence number a
    launch reported) and a mapped host word the card writes it to, with the
    last sequence number handed out.  A walk holds its word from
    :func:`walk_state` until it is dropped, so walks on one index from
    several threads report apart."""

    def __init__(self, device) -> None:
        self.seen = torch.zeros(1, dtype=torch.int64, device=device)
        host, dev = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = LIBRARY.get().rs_host_word(ctypes.addressof(host),
                                            ctypes.addressof(dev))
        if rc != 0:
            raise RuntimeError(f"rs_host_word: CUDA error {rc}")
        self.host, self.dev = host.value, dev.value
        self._free = weakref.finalize(self, LIBRARY.get().rs_host_word_free,
                                      host.value)
        self.seq = 0


class _KernelView:
    """A placed index's checked view for the kernels, built once: the owner
    view and its address, the run's key boundaries and theirs, and the
    walks' live words not in use (:class:`_LiveWord`, reused: freeing
    pinned memory waits for the card)."""

    def __init__(self, view: ShardView, keys: RunKeys, device) -> None:
        self.view, self.keys = view, keys
        self.addr = ctypes.addressof(view)
        self.keys_addr = ctypes.addressof(keys)
        self.device = device
        self._words: list[_LiveWord] = []
        self._lock = threading.Lock()

    def take_word(self) -> _LiveWord:
        with self._lock:
            if self._words:
                return self._words.pop()
        return _LiveWord(self.device)

    def give_word(self, word: _LiveWord) -> None:
        with self._lock:
            self._words.append(word)


def _bounds(name: str, starts, lens) -> list[int]:
    """A run's S + 1 contiguous boundaries of one kind of key."""
    st, ln = starts.tolist(), lens.tolist()
    for s in range(len(st) - 1):
        if st[s] + ln[s] != st[s + 1]:
            raise ValueError(f"the run's {name} ranges are not contiguous")
    return st + [st[-1] + ln[-1]]


def _view(sidx) -> _KernelView:
    """The checked owner view of a placed index on the card, built and
    checked on the first call and kept on the index (a placed index's
    tensors do not change)."""
    kv = sidx.kernel_cache.get("view")
    if kv is not None:
        return kv
    S = sidx.starts.shape[0]  # this run's shards
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(
            f"the sharded kernels take 1..{MAX_SHARDS} shards, got {S}")
    dev = sidx.starts.device
    rw = sidx.rank_rows.shape[2]
    for f in ("starts", "lens", "dstarts", "dlens", "rstarts", "rlens"):
        _check64(f, getattr(sidx, f), dev, (S,))
    _check64("C", sidx.C, dev, (6,))
    _check64("sym_prefix", sidx.sym_prefix, dev, (S + 1, 5))
    _check_stack("rank_rows", sidx.rank_rows, dev, S, rw)
    for f in ("sym4", "dollar_chunk", "sample_chunk"):
        _check_stack(f, getattr(sidx, f), dev, S)
    v = ShardView()
    v.S, v.n, v.num_reads = S, sidx.n, sidx.num_reads
    v.log2_block, v.words_per_block = sidx.log2_block, sidx.words_per_block
    v.row_words, v.rows_per_symbol = rw, sidx.rows_per_symbol
    v.max_read_len = sidx.max_read_len
    v.starts, v.lens, v.C = ptr(sidx.starts), ptr(sidx.lens), ptr(sidx.C)
    v.rank, v.rank_stride = ptr(sidx.rank_rows), sidx.rank_rows[0].numel()
    v.rank_prefix = ptr(sidx.sym_prefix)
    for k, (tab, cs, pre, P) in {
        2: (sidx.rank2_rows, sidx.C2, sidx.prefix2, 16),
        3: (sidx.rank3_rows, sidx.C3, sidx.prefix3, 64),
    }.items():
        if tab is None:
            continue
        _check_stack(f"rank{k}_rows", tab, dev, S, rw)
        _check64(f"C{k}", cs, dev, (P,))
        _check64(f"prefix{k}", pre, dev, (S + 1, P))
        setattr(v, f"rank{k}", ptr(tab))
        setattr(v, f"rank{k}_stride", tab[0].numel())
        setattr(v, f"rank{k}_prefix", ptr(pre))
        setattr(v, f"C{k}", ptr(cs))
    v.sym4, v.sym4_stride = ptr(sidx.sym4), sidx.sym4.shape[1]
    v.dollar, v.dollar_stride = ptr(sidx.dollar_chunk), sidx.dollar_chunk.shape[1]
    v.dstarts, v.dlens = ptr(sidx.dstarts), ptr(sidx.dlens)
    v.sample, v.sample_stride = ptr(sidx.sample_chunk), sidx.sample_chunk.shape[1]
    v.rstarts, v.rlens = ptr(sidx.rstarts), ptr(sidx.rlens)
    keys = RunKeys()
    keys.S = S
    keys.pos[: S + 1] = _bounds("position", sidx.starts, sidx.lens)
    keys.dol[: S + 1] = _bounds("$-rank", sidx.dstarts, sidx.dlens)
    keys.rid[: S + 1] = _bounds("read-id", sidx.rstarts, sidx.rlens)
    if sidx.dsa_chunk is not None and sidx.dsa_bits > 0:
        if not 1 <= sidx.dsa_bits <= 31:
            raise ValueError(f"dsa_bits must be in [1, 31], got {sidx.dsa_bits}")
        _check_stack("dsa_chunk", sidx.dsa_chunk, dev, S)
        v.dsa, v.dsa_stride = ptr(sidx.dsa_chunk), sidx.dsa_chunk.shape[1]
        v.dsa_bits = sidx.dsa_bits
    if sidx.mark_table is not None:
        _check_stack("mark_table", sidx.mark_table, dev, S, rw)
        _check64("mark_prefix", sidx.mark_prefix, dev, (S + 1,))
        v.marks, v.marks_stride = ptr(sidx.mark_table), sidx.mark_table[0].numel()
        v.mark_prefix = ptr(sidx.mark_prefix)
    if sidx.has_fast_resolve:
        _check_stack("lf_chunk", sidx.lf_chunk, dev, S)
        _check_stack("spairs_chunk", sidx.spairs_chunk, dev, S)
        if sidx.mark_table is None or sidx.spairs_chunk.shape[2:] != (2,):
            raise ValueError("the lf tier needs the mark table and [S, n, 2] "
                             "sample pairs")
        for f in ("sstarts", "slens"):
            _check64(f, getattr(sidx, f), dev, (S,))
        v.lf, v.lf_stride = ptr(sidx.lf_chunk), sidx.lf_chunk.shape[1]
        v.spairs = ptr(sidx.spairs_chunk)
        v.spairs_stride = sidx.spairs_chunk.shape[1]
        v.sstarts, v.slens = ptr(sidx.sstarts), ptr(sidx.slens)
        v.sample_rate = sidx.sample_rate
        keys.slot[: S + 1] = _bounds("mark-rank", sidx.sstarts, sidx.slens)
    kv = sidx.kernel_cache["view"] = _KernelView(v, keys, dev)
    return kv


def occ(sidx, table: str, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Global rank over a sharded table (``rank``, ``rank2``, ``rank3`` or
    ``marks``): c int32 [X], i int64 [X] → int64 [X].  K9 for a CUDA
    index, the plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        return occ_plain(sidx, table, c, i)
    t, _, _ = _table(sidx, table)
    if t is None:
        raise ValueError(f"the index carries no {table} table")
    v = _view(sidx)
    dev = sidx.starts.device
    X = i.shape[0]
    check_int32("c", c, dev, (X,))
    _check64("i", i, dev, (X,))
    out = torch.empty(X, dtype=torch.int64, device=dev)
    if X:
        SHARD_OCC(v.addr, TABLES[table], ptr(c), ptr(i),
                  ptr(out), X, device=dev)
    return out


def lut_level(sidx, l, u, *, max_chunk: int = 1 << 22):
    """K11: [X] level-ℓ intervals (int64) → level ℓ+1's [4X], c-major,
    empties frozen.  One launch per ``max_chunk`` intervals for a CUDA
    index; the plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        return lut_level_plain(sidx, l, u)
    v = _view(sidx)
    dev = sidx.starts.device
    X = l.shape[0]
    _check64("l", l, dev, (X,))
    _check64("u", u, dev, (X,))
    nl = torch.empty(4 * X, dtype=torch.int64, device=dev)
    nu = torch.empty_like(nl)
    for a in range(0, X, max_chunk):
        SHARDED_LUT_LEVEL(
            v.addr, ptr(l) + 8 * a, ptr(u) + 8 * a,
            min(max_chunk, X - a), ptr(nl) + 8 * a, ptr(nu) + 8 * a, X,
            device=dev,
        )
    return nl, nu


def search(sidx, kmers, lengths, lut, p: int, kstep: int, *,
           early_exit: bool = False, bad=None):
    """The sharded backward search → int64 (l, u) [B], empties (0, 0).
    ``kstep`` 1: the masked 1-step scan (``lengths`` required); 2 or 3:
    the pair (and triple) schedule, every query of length K.  From the
    int64 LUT of order ``p`` when ``lut`` is given.

    The search kernel for a CUDA index: K2's body, one thread per query
    through all of its steps, each rank at the owner shard.  With ``bad``
    (int32 [1] on the card) refused queries are counted there and the call
    does not wait; without it the wrapper reads the count and raises
    ``ValueError``.  The plain form for a CPU index."""
    if lut is None:
        p = 0
    if not on_cuda(sidx.starts):
        return search_plain(sidx, kmers, lengths, lut, p, kstep, early_exit)
    v = _view(sidx)
    dev = sidx.starts.device
    check_int32("kmers", kmers, dev)
    if kmers.dim() != 2 or not 1 <= kmers.shape[1] <= SEARCH_MAX_K:
        raise ValueError(f"kmers must be [B, K] with K <= {SEARCH_MAX_K}, "
                         f"got {tuple(kmers.shape)}")
    B, K = kmers.shape
    if kstep >= 2:
        if sidx.rank2_rows is None or (kstep >= 3 and sidx.rank3_rows is None):
            raise ValueError(f"the index has no tier for kstep={kstep}")
        lengths = None
    else:
        if lengths is None:
            raise ValueError("the masked search needs per-query lengths")
        check_int32("lengths", lengths, dev, (B,))
    if lut is not None:
        if not 1 <= p <= K:
            raise ValueError(f"LUT order {p} outside [1, K={K}]")
        _check64("lut", lut, dev, (4**p, 2))
    wait = bad is None
    if wait:
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        check_int32("bad", bad, dev, (1,))
    l = torch.empty(B, dtype=torch.int64, device=dev)
    u = torch.empty_like(l)
    if B:
        SHARDED_SEARCH(
            v.addr, ptr(kmers), ptr(lengths), B, K, ptr(lut), p,
            kstep, ptr(l), ptr(u), ptr(bad), device=dev,
        )
        if wait:
            raise_if_refused(int(bad.item()), K)
    return l, u


def _walk_code(sidx) -> int:
    kind = walk_kind(sidx)
    if kind == "slow" and sidx.max_read_len < 1:
        raise ValueError("the slow walk needs max_read_len >= 1, got "
                         f"{sidx.max_read_len}")
    return WALK_KINDS[kind]


def resolve(sidx, rows, valid, *, walk_early_exit: bool = False):
    """K10 over SA rows: rows int64 [R] (0 where invalid), valid bool [R]
    → (read_id, offset, sample) int32 [R]; read_id and offset -1 where the
    lane is invalid or its walk did not end, sample that of read id
    ``clip(read_id, 0, m - 1)``.  One launch for a CUDA index, each lane
    carrying its row through the whole walk (``walk_early_exit`` is
    implied); the plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        return resolve_plain(sidx, rows, valid, walk_early_exit)
    v = _view(sidx)
    dev = sidx.starts.device
    R = rows.shape[0]
    _check64("rows", rows, dev, (R,))
    if valid.dtype != torch.bool or valid.shape != rows.shape:
        raise ValueError("valid must be a bool tensor shaped like rows")
    valid = valid.contiguous()
    rid = torch.empty(R, dtype=torch.int32, device=dev)
    off = torch.empty_like(rid)
    smp = torch.empty_like(rid)
    if R:
        SHARDED_RESOLVE(
            v.addr, _walk_code(sidx), ptr(rows), ptr(valid), R,
            ptr(rid), ptr(off), ptr(smp), None, None, 0, 0, 0, None,
            device=dev,
        )
    return rid, off, smp


def sweep(sidx, l, u, window: int, max_rows: int | None = None, *,
          walk_early_exit: bool = False):
    """Exact per-sample attribution over the full intervals (the JAX
    sharded ``exact_hist`` sweep): → (hist int32 [B, num_samples],
    complete bool [B]).  The rows swept are ``min(total, ceil(max_rows /
    window) * window)`` of the concatenated intervals, and ``complete[b]``
    is ``cum[b] <= t_end * window``.  K10's sweep mode for a CUDA index
    (slots mapped to their queries on the card, one walk each and an
    atomic add; the limit is read on the card, so nothing waits); the
    plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        return sweep_plain(sidx, l, u, window, max_rows, walk_early_exit)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    v = _view(sidx)
    dev = sidx.starts.device
    B = l.shape[0]
    S = sidx.num_samples
    _check64("l", l, dev, (B,))
    _check64("u", u, dev, (B,))
    cum = torch.cumsum(u - l, 0)
    cap = _rounds_cap(max_rows, window)
    tw = (cum[B - 1] + window - 1) // window
    if cap is not None:
        tw = torch.clamp(tw, max=cap // window)
    hist = torch.zeros(B * S, dtype=torch.int32, device=dev)
    if cap != 0:
        SHARDED_RESOLVE(
            v.addr, _walk_code(sidx), None, None, 0, None, None,
            None, ptr(l), ptr(cum), B, -1 if cap is None else cap, S,
            ptr(hist), device=dev,
        )
    return hist.reshape(B, S), cum <= tw * window


# ------------------------------------------------- one rank's partials


def occ_partial(sidx, table: str, c, i):
    """K9's partial: the rank over ``sidx``'s run of shards only, a rank's
    share of a global rank, Σ_{s in run} occ_s(c, clip(i - start_s, 0,
    len_s)): c int32 [X] (a plane of ``table``), i int64 [X] → int64 [X].
    The kernel for a CUDA index; for a CPU index :func:`occ_plain` on the
    run, its plain form."""
    if not on_cuda(sidx.starts):
        return occ_plain(sidx, table, c, i)
    if _table(sidx, table)[0] is None:
        raise ValueError(f"the index carries no {table} table")
    v = _view(sidx)
    X = i.shape[0]
    check_int32("c", c, v.device, (X,))
    _check64("i", i, v.device, (X,))
    out = torch.empty(X, dtype=torch.int64, device=v.device)
    if X:
        SHARD_OCC_PARTIAL(v.addr, v.keys_addr, TABLES[table], ptr(c), None,
                          0, 0, 0, 0, ptr(i), X, ptr(out), device=v.device)
    return out


def step_partial(sidx, k: int, kmers, lengths, col: int, lu, lead: bool,
                 out=None):
    """K9's partial of one search step (see :func:`step_partial_plain`):
    kmers int32 [B, K], lengths int32 [B] or None (no length mask), the
    reduced lu int64 [2B] → int64 [2B], into ``out`` when given (which may
    be ``lu`` itself: the search updates its interval in place).  One
    launch for a CUDA index, the plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        got = step_partial_plain(sidx, k, kmers, lengths, col, lu, lead)
        return got if out is None else out.copy_(got)
    table = STEP_TABLES.get(k)
    if table is None or _table(sidx, table)[0] is None:
        raise ValueError(f"the index has no table for a step of {k} columns")
    v = _view(sidx)
    dev = v.device
    check_int32("kmers", kmers, dev)
    if kmers.dim() != 2 or not 1 <= kmers.shape[1] <= SEARCH_MAX_K:
        raise ValueError(f"kmers must be [B, K] with K <= {SEARCH_MAX_K}, "
                         f"got {tuple(kmers.shape)}")
    B, K = kmers.shape
    if not 0 <= col <= K - k:
        raise ValueError(f"a step of {k} columns from column {col} leaves "
                         f"the {K} columns")
    if lengths is not None:
        check_int32("lengths", lengths, dev, (B,))
    _check64("lu", lu, dev, (2 * B,))
    if out is None:
        out = torch.empty(2 * B, dtype=torch.int64, device=dev)
    else:
        _check64("out", out, dev, (2 * B,))
    if B:
        SHARD_OCC_PARTIAL(v.addr, v.keys_addr, TABLES[table], ptr(kmers),
                          ptr(lengths), K, col, k, int(lead), ptr(lu), B,
                          ptr(out), device=dev)
    return out


def lookup_partial(sidx, what: str, x, y=None):
    """K13: lookup ``what`` over ``sidx``'s run of shards, 0 where none
    owns the key (see :func:`lookup_partial_plain`): x (and y, the slots
    of ``dollar_pair``) int64 [X] → int32 [X] ([3X] ``dollar_pair``), int64
    [2X] ``lf_mark``.  One launch for a CUDA index, the plain form for a
    CPU index."""
    if what not in LOOKUPS:
        raise ValueError(f"no sharded lookup {what!r}")
    if not on_cuda(sidx.starts):
        return lookup_partial_plain(sidx, what, x, y)
    v = _view(sidx)
    X = x.shape[0]
    _check64("x", x, v.device, (X,))
    if what == "dollar_pair":
        if y is None:
            raise ValueError("dollar_pair needs the mark-rank slots y")
        _check64("y", y, v.device, (X,))
    out = torch.empty(LOOKUP_WIDTH.get(what, 1) * X, device=v.device,
                      dtype=torch.int64 if what == "lf_mark" else torch.int32)
    if X:
        SHARD_LOOKUP_PARTIAL(v.addr, v.keys_addr, LOOKUPS[what], ptr(x),
                             ptr(y) if what == "dollar_pair" else None, X,
                             ptr(out), device=v.device)
    return out


def lut_level_partial(sidx, l, u, lead: bool, *, max_chunk: int = 1 << 22):
    """K11's partial: level-ℓ intervals (int64 [X]) → the run's partial of
    level ℓ+1, int64 [8X] (see :func:`lut_level_partial_plain`).  One
    launch per ``max_chunk`` intervals for a CUDA index; the plain form for
    a CPU index."""
    if not on_cuda(sidx.starts):
        return lut_level_partial_plain(sidx, l, u, lead)
    v = _view(sidx)
    X = l.shape[0]
    _check64("l", l, v.device, (X,))
    _check64("u", u, v.device, (X,))
    out = torch.empty(8 * X, dtype=torch.int64, device=v.device)
    for a in range(0, X, max_chunk):
        SHARDED_LUT_LEVEL_PARTIAL(
            v.addr, v.keys_addr, ptr(l) + 8 * a, ptr(u) + 8 * a,
            min(max_chunk, X - a), int(lead), ptr(out) + 8 * a, X,
            device=v.device,
        )
    return out


# ------------------------------------------------ the cross-rank walks' steps


# csrc/sharded_partial.cu's Walk, field for field: every field 8 bytes, a
# pointer as an integer address, 0 for a buffer the walk does not use
_WALK_FIELDS = ("X", "lead", "rows", "valid", "cur", "done", "count",
                "step32", "step64", "term64", "term32", "read_id", "offset",
                "seen", "live")


class WalkBuffers(ctypes.Structure):
    _fields_ = [(name, ctypes.c_longlong) for name in _WALK_FIELDS]


def walk_state(sidx, rows, valid, lead: bool) -> WalkState:
    """A cross-rank walk of ``rows`` (int64 [R], 0 where invalid) and
    ``valid`` (bool [R]) on the index's route (lf or slow): its state and
    buffers on the index's device, allocated and, for a CUDA index, checked
    once for all of its steps.  ``lead``: this rank is its row's lead."""
    kind = walk_kind(sidx)
    if kind not in ("lf", "slow"):
        raise ValueError(f"the {kind} route has no walk steps")
    R = rows.shape[0]
    dev = rows.device

    def new(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)

    i32, i64 = torch.int32, torch.int64
    st = WalkState(
        kind=kind, lead=bool(lead), rows=rows, valid=valid, cur=new(R, i64),
        done=new(R, torch.bool), count=new(R, i32), step32=new(R, i32),
        step64=new(R, i64) if kind == "slow" else None,
        term64=new(2 * R, i64) if kind == "lf" else None,
        term32=new(3 * R if kind == "lf" else R, i32), read_id=new(R, i32),
        offset=new(R, i32))
    if not on_cuda(sidx.starts):
        return st
    v = _view(sidx)
    _check64("rows", rows, v.device, (R,))
    if valid.dtype != torch.bool or valid.shape != rows.shape or \
            not valid.is_contiguous() or valid.device != v.device:
        raise ValueError("valid must be a contiguous bool tensor shaped like "
                         "rows, on the index's device")
    b = st.buffers = WalkBuffers()
    b.X, b.lead = R, int(lead)
    for f in _WALK_FIELDS[2:-2]:
        setattr(b, f, ptr(getattr(st, f)) or 0)
    w = st.word = v.take_word()
    weakref.finalize(st, v.give_word, w)
    b.seen, b.live = ptr(w.seen), w.dev
    return st


def _walk_launch(kernel, sidx, st: WalkState, mode: str, *t) -> None:
    v = _view(sidx)
    st.word.seq += 1
    st.seq = st.word.seq
    if st.rows.shape[0]:
        kernel(v.addr, v.keys_addr, ctypes.addressof(st.buffers),
               WALK_MODES[mode], *t, st.seq, device=v.device)


def lf_walk_step(sidx, st: WalkState, mode: str) -> None:
    """The sampled-LF walk's step ``mode`` (``first``, ``step``, ``last``,
    ``terminal`` or ``finish``; see :func:`lf_walk_step_plain`) on ``st``,
    in place: one launch of ``rs_walk_lf_step`` for a CUDA index, the plain
    form for a CPU index."""
    if not on_cuda(sidx.starts):
        return lf_walk_step_plain(sidx, st, mode)
    if mode == "rank" or st.kind != "lf":
        raise ValueError(f"no LF walk step {mode!r} on a {st.kind} walk")
    _walk_launch(WALK_LF_STEP, sidx, st, mode)


def slow_walk_step(sidx, st: WalkState, mode: str, t: int = 0) -> None:
    """The slow walk's step ``mode`` (``first``, ``rank``, ``step``,
    ``last`` or ``finish``, at step ``t``; see :func:`slow_walk_step_plain`)
    on ``st``, in place: one launch of ``rs_walk_slow_step`` for a CUDA
    index, the plain form for a CPU index."""
    if not on_cuda(sidx.starts):
        return slow_walk_step_plain(sidx, st, mode, t)
    if mode == "terminal" or st.kind != "slow":
        raise ValueError(f"no slow walk step {mode!r} on a {st.kind} walk")
    _walk_launch(WALK_SLOW_STEP, sidx, st, mode, t)


def walk_live(sidx, st: WalkState) -> bool:
    """Whether a lane of the walk was live after its last ``first`` or
    ``step``: for a CUDA index one wait for the stream, then the host word
    that launch wrote (no reduction over the lanes, no copy); the plain
    forms' report for a CPU index."""
    if not on_cuda(sidx.starts):
        return st.live
    v = _view(sidx)
    torch.cuda.current_stream(v.device).synchronize()
    return ctypes.c_ulonglong.from_address(st.word.host).value == st.seq
