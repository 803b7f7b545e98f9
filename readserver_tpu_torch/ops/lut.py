"""Prefix LUT: intervals of every p-mer, built on the device by level BFS.

``lut[id(w)] = [l, u)`` for all 4^p strings ``w`` of length p, where
``id(w) = Σ (w[t]-1)·4^(p-1-t)`` (first character most significant).

Level ℓ extends to ℓ+1 with the same backward-search update the query path
uses, so LUT-started searches are bit-exact with step-by-step searches.
Prepending char c maps id(w) → (c-1)·4^ℓ + id(w), so level ℓ+1 is four
c-blocks of the extended level-ℓ table, in c order.  Total ≈ 2.7·4^p ranks.

Two forms: :func:`build_prefix_lut_plain`, the level extension of the JAX
package's ``ops/lut.py`` in plain torch (any device), and K1's level entry
(``csrc/rank.cu::rs_lut_level``, :func:`extend_level`), which writes each
level straight into the next one's tensors, the last level as the LUT
itself.  :func:`build_prefix_lut` launches the level entry for a CUDA index
and takes the plain form for a CPU index.
"""

from __future__ import annotations

import numpy as np
import torch

from readserver_tpu_torch.kernels import LUT_LEVEL
from readserver_tpu_torch.kernels.build import check_int32, on_cuda, ptr
from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops.search import canonical_empty
from readserver_tpu_torch.ops.types import DeviceIndex


def _occ_plain(index: DeviceIndex, c: torch.Tensor, i: torch.Tensor):
    return rank_ops.occ_rows_plain(
        index.rank_rows, c, i, rows_per_symbol=index.rows_per_symbol,
        log2_block=index.log2_block, words_per_block=index.words_per_block,
    )


def extend_level_plain(index: DeviceIndex, l: torch.Tensor, u: torch.Tensor):
    """[S] intervals of level ℓ → [4S] intervals of level ℓ+1 (c-major).

    Already-empty intervals are frozen rather than re-extended so LUT
    entries are bit-identical to what the step-by-step search (whose
    ``active`` mask stops updating on emptiness) would produce."""
    S = l.shape[0]
    cc = torch.arange(1, 5, dtype=torch.int32, device=l.device)
    cc = cc.repeat_interleave(S)                                   # [4S]
    l4 = l.repeat(4)
    u4 = u.repeat(4)
    occ2 = _occ_plain(index, torch.cat([cc, cc]), torch.cat([l4, u4]))
    base = index.C.index_select(0, cc.to(torch.int64))
    alive = l4 < u4
    nl = torch.where(alive, base + occ2[: 4 * S], l4)
    nu = torch.where(alive, base + occ2[4 * S :], u4)
    return nl, nu


def _check_order(p: int, max_chunk: int) -> None:
    if not (1 <= p <= 15):
        raise ValueError("prefix LUT order must be in [1, 15]")
    if max_chunk < 1:
        raise ValueError("max_chunk must be >= 1")


def _pairs(l: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    l, u = canonical_empty(l, u)  # absent p-mers: (0, 0), like every path
    return torch.stack([l, u], dim=1).contiguous()


def extend_level(
    index: DeviceIndex,
    l: torch.Tensor,
    u: torch.Tensor,
    *,
    last: bool = False,
    max_chunk: int = 1 << 22,
):
    """K1's level entry: [S] level-ℓ intervals → level ℓ+1, c-major, as
    ``(l, u)`` int32 [4S] each, or with ``last`` as the LUT's int32 [4S, 2]
    pairs with empties ``(0, 0)``.  One launch per ``max_chunk`` intervals
    for CUDA tensors (``l`` and ``u`` contiguous); the plain form
    (:func:`extend_level_plain`) for CPU tensors."""
    if not on_cuda(index.rank_rows):
        nl, nu = extend_level_plain(index, l, u)
        return _pairs(nl, nu) if last else (nl, nu)
    rank_ops._check_table(index.rank_rows)
    dev = index.device
    S = l.shape[0]
    check_int32("l", l, dev, (S,))
    check_int32("u", u, dev, (S,))
    check_int32("C", index.C, dev, (6,))
    if last:
        out = torch.empty((4 * S, 2), dtype=torch.int32, device=dev)
    else:
        nl = torch.empty(4 * S, dtype=torch.int32, device=dev)
        nu = torch.empty_like(nl)
    for a in range(0, S, max_chunk):
        LUT_LEVEL(
            ptr(index.rank_rows), ptr(index.C), ptr(l) + 4 * a,
            ptr(u) + 4 * a, min(max_chunk, S - a),
            None if last else ptr(nl) + 4 * a,
            None if last else ptr(nu) + 4 * a,
            ptr(out) + 8 * a if last else None, S,
            index.rows_per_symbol, index.log2_block, index.words_per_block,
            index.rank_rows.shape[1], device=dev,
        )
    return out if last else (nl, nu)


def build_prefix_lut(
    index: DeviceIndex, p: int, max_chunk: int = 1 << 22
) -> torch.Tensor:
    """→ int32 [4^p, 2] on the index's device.

    On the card, one :func:`extend_level` per level: ``max_chunk`` bounds
    the intervals one launch takes (at the default, every level up to
    p = 12 is one launch), and the build makes no tensors besides each
    level's own.  The result is the same bits for every ``max_chunk``.
    For a CPU index, :func:`build_prefix_lut_plain`."""
    if not on_cuda(index.rank_rows):
        return build_prefix_lut_plain(index, p, max_chunk)
    _check_order(p, max_chunk)
    l = index.C[1:5]
    u = index.C[2:6]
    if p == 1:
        return _pairs(l, u)
    for _ in range(p - 2):
        l, u = extend_level(index, l, u, max_chunk=max_chunk)
    return extend_level(index, l, u, last=True, max_chunk=max_chunk)


def build_prefix_lut_plain(
    index: DeviceIndex, p: int, max_chunk: int = 1 << 22
) -> torch.Tensor:
    """Plain torch form of :func:`build_prefix_lut` (no kernel on any
    device), the reference K1's level entry is checked against on the card.

    Levels above ``max_chunk`` entries extend in chunks, which bounds the
    temporaries of one extension.  Chunking is exact — each entry's
    extension depends only on that entry — but must slice PER PREPEND-CHAR c
    (the output is c-major), so each level-ℓ chunk [a:b) produces four
    output slices k·4^ℓ + [a:b), k = c-1."""
    _check_order(p, max_chunk)
    l = index.C[1:5]
    u = index.C[2:6]
    size = 4
    for _ in range(p - 1):
        if size <= max_chunk:
            l, u = extend_level_plain(index, l, u)
        else:
            parts = [[] for _ in range(8)]  # 4 c-blocks × (l, u)
            for a in range(0, size, max_chunk):
                b = min(a + max_chunk, size)
                cl, cu = extend_level_plain(index, l[a:b], u[a:b])
                for k in range(4):
                    parts[2 * k].append(cl[k * (b - a) : (k + 1) * (b - a)])
                    parts[2 * k + 1].append(
                        cu[k * (b - a) : (k + 1) * (b - a)]
                    )
            l = torch.cat([c for k in range(4) for c in parts[2 * k]])
            u = torch.cat([c for k in range(4) for c in parts[2 * k + 1]])
        size *= 4
    return _pairs(l, u)


def default_lut_order(n: int, max_order: int = 12) -> int:
    """Pick p so the LUT is populated but not wasteful: ~log4(n) - 1,
    clamped to [4, max_order].  The cap of 12 is the JAX package's, kept so
    both engines pick the same p; tuning it for the H100 is open work."""
    if n <= 0:
        return 4
    logn = int(np.log2(max(n, 2)) / 2)
    return int(np.clip(logn - 1, 4, max_order))
