"""The served answer's sparse pack (K8) and the cohort merge with its pack.

A port of ``sparse_pack_device`` and ``MultiEngine._merge_full`` of the JAX
package's ``serve/engine.py``: a batch's answers leave the device as ONE
small int32 buffer,

  [count(W), count_hi(W)?, complete(W), trunc(W)?, (l(W), u(W))?,
   n_hist, hist_idx(R), hist_val(R),
   (n_hits, hit_idx(R), read_id(R), offset(R), sample(R))?, bad]

where the histogram cells > 0 and the hit lanes with a read id (of the
queries below ``nq``) are compacted in flat, query-major order into ``R =
cpq * W`` slots a section, -1 in the slots past them, and ``n`` is the
number kept or -1 on an overflow, where the host reads the dense tensors
instead.  ``bad`` is the search's refused-query count.

* :func:`pack_answer`: one engine's answer (K8, ``rs_sparse_pack``);
* :func:`merge_pack`: a cohort's partitions' dense buffers merged on the
  device (int64 count sum, product of the complete flags, histograms added
  by sample id, read ids shifted to global ids, hit lanes concatenated)
  and packed (``rs_merge_pack``).

Both launch their kernel (``csrc/pack.cu``) for CUDA tensors and run the
plain forms (:func:`pack_answer_plain`, :func:`merge_pack_plain`, built on
:func:`sparse_pack_plain`, the JAX package's torch ops) for CPU tensors.
The kernels write the packed buffer alone: the dense fallbacks come back
as zero-argument callables that assemble them (torch ops on the device)
only when an overflow asks for them (:func:`dense`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from readserver_tpu_torch.kernels import MERGE_PACK, SPARSE_PACK
from readserver_tpu_torch.kernels.build import check_int32, on_cuda, ptr

TILE = 2048     # cells or lanes a block of csrc/pack.cu takes
MAX_PARTS = 64  # partitions rs_merge_pack takes


def dense(t):
    """A dense fallback as :func:`pack_answer` or :func:`merge_pack` gave
    it: a tensor, or a callable that assembles it."""
    return t() if callable(t) else t


def _compact_cols(mask: torch.Tensor, cols, R: int):
    """Order-preserving compaction of ``cols`` where ``mask`` → fixed [R]
    buffers + the kept count (-1 signals overflow → dense fallback).  A
    cumsum plus a scatter; slot R is the overflow slot, cut off after."""
    m32 = mask.to(torch.int32)
    pos = torch.cumsum(m32, 0) - m32
    keep = mask & (pos < R)
    slot = torch.where(keep, pos, torch.full_like(pos, R))
    outs = [
        torch.full((R + 1,), -1, dtype=torch.int32, device=mask.device)
        .scatter(0, slot, c.to(torch.int32))[:R]
        for c in cols
    ]
    total = m32.sum()
    n = torch.where(total > R, torch.full_like(total, -1), total)
    return n.to(torch.int32), outs


def sparse_pack_plain(
    count, complete, hist, rid, off, smp, nq, cpq, bad, l=None, u=None,
    trunc=None, count_hi=None,
):
    """The JAX package's ``sparse_pack_device`` in torch ops, with ``bad``
    (int32 [1]) as the buffer's last word: every layout (``count_hi``,
    ``trunc``, ``l`` and ``u`` each optional, ``rid=None`` for a
    histogram-only answer).  Returns ``(packed, hist, dense_hits)``, the
    dense tensors backing an overflow (n == -1)."""
    W = count.shape[0]
    R = cpq * W
    dev = count.device
    segs = [count.to(torch.int32)]
    if count_hi is not None:
        segs.append(count_hi.to(torch.int32))
    segs.append(complete.to(torch.int32))
    if trunc is not None:
        segs.append(trunc.to(torch.int32))
    if l is not None:
        segs += [l.to(torch.int32), u.to(torch.int32)]
    NS = hist.shape[1]
    cells = torch.arange(W * NS, dtype=torch.int32, device=dev)
    n_hist, (hist_idx, hist_val) = _compact_cols(
        (hist.reshape(-1) > 0) & (cells // NS < nq),
        [cells, hist.reshape(-1)],
        R,
    )
    segs += [n_hist.reshape(1), hist_idx, hist_val]
    dense_hits = None
    if rid is not None:
        SH = rid.shape[1]
        lanes = torch.arange(W * SH, dtype=torch.int32, device=dev)
        n_hits, (hit_idx, hit_rid, hit_off, hit_smp) = _compact_cols(
            (rid.reshape(-1) >= 0) & (lanes // SH < nq),
            [lanes, rid.reshape(-1), off.reshape(-1), smp.reshape(-1)],
            R,
        )
        segs += [n_hits.reshape(1), hit_idx, hit_rid, hit_off, hit_smp]
        dense_hits = torch.cat([rid, off, smp], dim=1)
    segs.append(bad)
    return torch.cat(segs), hist, dense_hits


def _words(W: int, R: int, count_hi: bool, trunc: bool, lu: bool,
           hits: bool) -> int:
    """Words of the packed buffer (``csrc/pack.cu``'s layout)."""
    return (W * (2 + count_hi + trunc + 2 * lu) + 2 + 2 * R
            + (1 + 4 * R if hits else 0))


def _scratch(W: int, NS: int, SH: int, dev) -> torch.Tensor:
    """The kernels' scratch: each tile's kept count, the cells' tiles then
    the lanes'."""
    return torch.empty(-(-W * NS // TILE) + -(-W * SH // TILE),
                       dtype=torch.int32, device=dev)


def _check_pack(W: int, nq: int, NS: int, SH: int, cpq: int) -> int:
    """→ R; raise ``ValueError`` for a shape the kernels do not take."""
    R = cpq * W
    if (W < 1 or not 0 <= nq <= W or NS < 1 or cpq < 0
            or W * max(NS, SH) >= 1 << 31 or 6 * (W + R) + 3 >= 1 << 31):
        raise ValueError(
            f"the pack takes 1 <= W, 0 <= nq <= W, NS >= 1 and int32 "
            f"indices, got W={W}, nq={nq}, NS={NS}, SH={SH}, cpq={cpq}")
    return R


def pack_answer_plain(l, u, complete, hist, rid, off, smp, nq: int,
                      cpq: int, bad, max_hits: int):
    """Plain form of :func:`pack_answer`: :func:`sparse_pack_plain` of
    ``count = u - l`` with ``l`` and ``u``, and on the histogram tier
    ``trunc = count > max_hits``."""
    count = u - l
    return sparse_pack_plain(
        count, complete, hist, rid, off, smp, nq, cpq, bad, l=l, u=u,
        trunc=None if rid is not None else count > max_hits)


def pack_answer(
    l: torch.Tensor,
    u: torch.Tensor,
    complete: torch.Tensor,
    hist: torch.Tensor,
    rid: torch.Tensor | None,
    off: torch.Tensor | None,
    smp: torch.Tensor | None,
    nq: int,
    cpq: int,
    bad: torch.Tensor,
    max_hits: int,
):
    """K8: one engine's answer to a batch of W queries (int32 ``l, u``
    [W], bool ``complete`` [W], int32 ``hist`` [W, NS], and on the full
    tier int32 ``rid, off, smp`` [W, SH], -1 where a lane holds no hit;
    None on the histogram tier, whose ``trunc`` flag is ``u - l >
    max_hits``) → ``(packed, hist, dense_hits)``.  ``cpq`` slots a query
    a section.  ``rs_sparse_pack`` for CUDA tensors (two launches, no
    copy of the dense hits: ``dense_hits`` is a callable concatenating
    them on an overflow), the plain form for CPU tensors."""
    if not on_cuda(l):
        return pack_answer_plain(l, u, complete, hist, rid, off, smp, nq,
                                 cpq, bad, max_hits)
    dev = l.device
    W = l.shape[0]
    NS = hist.shape[1]
    SH = 0 if rid is None else rid.shape[1]
    R = _check_pack(W, nq, NS, SH, cpq)
    check_int32("l", l, dev, (W,))
    check_int32("u", u, dev, (W,))
    check_int32("hist", hist, dev, (W, NS))
    check_int32("bad", bad, dev, (1,))
    if (complete.device != dev or complete.dtype != torch.bool
            or not complete.is_contiguous() or complete.shape != (W,)):
        raise ValueError(f"complete must be a contiguous bool tensor of "
                         f"shape ({W},) on {dev}")
    hits = (rid, off, smp)
    if rid is not None:
        for name, t in zip(("rid", "off", "smp"), hits):
            check_int32(name, t, dev, (W, max(SH, 1)))
    elif off is not None or smp is not None:
        raise ValueError("rid, off and smp come together")
    out = torch.empty(_words(W, R, False, not SH, True, bool(SH)),
                      dtype=torch.int32, device=dev)
    scratch = _scratch(W, NS, SH, dev)
    SPARSE_PACK(ptr(l), ptr(u), ptr(complete), ptr(hist), W, NS, ptr(rid),
                ptr(off), ptr(smp), SH, nq, R, -1 if SH else max_hits,
                ptr(bad), ptr(scratch), scratch.numel(), ptr(out),
                out.numel(), device=dev)
    return out, hist, (lambda: torch.cat(hits, dim=1)) if SH else None


def merge_dense(outs, ns, bases, NS: int, H: int, with_hits: bool):
    """Merge of the partitions' dense [W, 4+ns_p(+3H)] int32 buffers →
    ``(count, complete, hist, read_id, offset, sample, trunc)``: counts
    add in int64; ``complete`` is the product of the partitions' flags;
    partition p's histogram adds into columns ``[:, :ns[p]]`` of the
    cohort's ``NS``; read ids shift by ``bases[p]``, -1 kept, and hit lanes
    concatenate partition by partition.  Without hits the three hit
    tensors are None and ``trunc`` is the histogram tier's flag (some
    partition's count past ``H``); with hits ``trunc`` is None."""
    W = outs[0].shape[0]
    dev = outs[0].device
    count = torch.zeros(W, dtype=torch.int64, device=dev)
    complete = torch.ones(W, dtype=torch.int32, device=dev)
    trunc = torch.zeros(W, dtype=torch.bool, device=dev)
    hist = torch.zeros((W, NS), dtype=torch.int32, device=dev)
    rids, offs, smps = [], [], []
    for o, ns_s, base in zip(outs, ns, bases):
        count += o[:, 2].to(torch.int64)
        complete *= o[:, 3]
        hist[:, :ns_s] += o[:, 4 : 4 + ns_s]
        if with_hits:
            rid = o[:, 4 + ns_s : 4 + ns_s + H]
            rids.append(torch.where(rid >= 0, rid + base, -1))
            offs.append(o[:, 4 + ns_s + H : 4 + ns_s + 2 * H])
            smps.append(o[:, 4 + ns_s + 2 * H : 4 + ns_s + 3 * H])
        else:
            # a follow-up hits query truncates iff some PARTITION's count
            # exceeds the per-query cap, visible only here.  As in the JAX
            # package, the flag reflects that cap only, not the whole-batch
            # row budget of a follow-up /reads
            trunc |= o[:, 2] > H
    if not with_hits:
        return count, complete, hist, None, None, None, trunc
    return (count, complete, hist, *(torch.cat(x, dim=1)
                                     for x in (rids, offs, smps)), None)


def merge_pack_plain(outs, ns, bases, NS: int, H: int, nq: int, cpq: int,
                     bad, with_hits: bool):
    """Plain form of :func:`merge_pack`: :func:`merge_dense`, then
    :func:`sparse_pack_plain` with the int64 count as two int32 lanes
    (bits 0-30, then 31+)."""
    count, complete, hist, rid, off, smp, trunc = merge_dense(
        outs, ns, bases, NS, H, with_hits)
    return sparse_pack_plain(
        count & 0x7FFFFFFF, complete, hist, rid, off, smp, nq, cpq, bad,
        trunc=trunc, count_hi=count >> 31)


def merge_pack(
    outs: list,
    ns: list,
    bases: list,
    NS: int,
    H: int,
    nq: int,
    cpq: int,
    bad: torch.Tensor,
    with_hits: bool,
):
    """The cohort merge and its pack: P partitions' dense int32 buffers
    ``outs[p]`` [W, >= 4 + ns[p] (+ 3H with hits)] whose rows begin with
    (l, u, count, complete, hist, (read_id, offset, sample)), as the
    plain form slices them, each partition's first
    global read id in ``bases`` → ``(packed, hist, dense_hits)`` as
    :func:`merge_pack_plain` gives them: the count as bits 0-30 and 31+,
    the histogram tier's ``trunc``, no ``l`` and ``u``.
    ``rs_merge_pack`` for CUDA tensors (two launches reading every
    partition's buffer in place; the dense fallbacks are callables that
    merge them by :func:`merge_dense` on an overflow), the plain form for
    CPU tensors."""
    if not on_cuda(outs[0]):
        return merge_pack_plain(outs, ns, bases, NS, H, nq, cpq, bad,
                                with_hits)
    dev = outs[0].device
    P = len(outs)
    W = outs[0].shape[0]
    SH = P * H if with_hits else 0
    R = _check_pack(W, nq, NS, SH, cpq)
    if not (1 <= P <= MAX_PARTS and len(ns) == P and len(bases) == P
            and H >= 1):
        raise ValueError(f"the merge takes 1 to {MAX_PARTS} partitions, "
                         f"each with its ns and base, and H >= 1")
    for p, (o, n, b) in enumerate(zip(outs, ns, bases)):
        check_int32(f"outs[{p}]", o, dev)
        if not (1 <= n <= NS and 0 <= b < 1 << 31 and o.dim() == 2
                and o.shape[0] == W
                and o.shape[1] >= 4 + n + (3 * H if with_hits else 0)):
            raise ValueError(
                f"partition {p}: ns {n} past the cohort's {NS}, base {b} "
                f"past int32, or rows of {tuple(o.shape)} too narrow for "
                f"its columns")
    check_int32("bad", bad, dev, (1,))
    out = torch.empty(_words(W, R, True, not with_hits, False, with_hits),
                      dtype=torch.int32, device=dev)
    scratch = _scratch(W, NS, SH, dev)
    parts = (ctypes.c_void_p * P)(*(o.data_ptr() for o in outs))
    ns_c = (ctypes.c_int * P)(*ns)
    strides_c = (ctypes.c_int * P)(*(o.shape[1] for o in outs))
    bases_c = (ctypes.c_int * P)(*bases)
    MERGE_PACK(ctypes.addressof(parts), ctypes.addressof(ns_c),
               ctypes.addressof(strides_c), ctypes.addressof(bases_c), P, W,
               NS, H, int(with_hits), nq, R, ptr(bad), ptr(scratch),
               scratch.numel(), ptr(out), out.numel(), device=dev)
    merged = functools.cache(
        lambda: merge_dense(outs, ns, bases, NS, H, with_hits))
    hits = (lambda: torch.cat(merged()[3:6], dim=1)) if with_hits else None
    return out, lambda: merged()[2], hits
