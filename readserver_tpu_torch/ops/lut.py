"""Prefix LUT: intervals of every p-mer, built on the device by level BFS.

``lut[id(w)] = [l, u)`` for all 4^p strings ``w`` of length p, where
``id(w) = Σ (w[t]-1)·4^(p-1-t)`` (first character most significant).

Level ℓ extends to ℓ+1 with the same backward-search update the query path
uses, so LUT-started searches are bit-exact with step-by-step searches.
Prepending char c maps id(w) → (c-1)·4^ℓ + id(w), so level ℓ+1 is four
c-blocks of the extended level-ℓ table, in c order.  Total ≈ 2.7·4^p ranks,
all through :func:`ops.rank.occ` (kernel K1 on a CUDA index);
:func:`build_prefix_lut_plain` runs the same levels through the plain rank
on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from readserver_tpu_torch.ops import rank as rank_ops
from readserver_tpu_torch.ops.search import canonical_empty
from readserver_tpu_torch.ops.types import DeviceIndex


def _occ_plain(index: DeviceIndex, c: torch.Tensor, i: torch.Tensor):
    return rank_ops.occ_rows_plain(
        index.rank_rows, c, i, rows_per_symbol=index.rows_per_symbol,
        log2_block=index.log2_block, words_per_block=index.words_per_block,
    )


def _extend_level(index: DeviceIndex, l: torch.Tensor, u: torch.Tensor, occ):
    """[S] intervals of level ℓ → [4S] intervals of level ℓ+1 (c-major).

    Already-empty intervals are frozen rather than re-extended so LUT
    entries are bit-identical to what the step-by-step search (whose
    ``active`` mask stops updating on emptiness) would produce."""
    S = l.shape[0]
    cc = torch.arange(1, 5, dtype=torch.int32, device=l.device)
    cc = cc.repeat_interleave(S)                                   # [4S]
    l4 = l.repeat(4)
    u4 = u.repeat(4)
    occ2 = occ(index, torch.cat([cc, cc]), torch.cat([l4, u4]))
    base = index.C.index_select(0, cc.to(torch.int64))
    alive = l4 < u4
    nl = torch.where(alive, base + occ2[: 4 * S], l4)
    nu = torch.where(alive, base + occ2[4 * S :], u4)
    return nl, nu


def build_prefix_lut(
    index: DeviceIndex, p: int, max_chunk: int = 1 << 22
) -> torch.Tensor:
    """→ int32 [4^p, 2] on the index's device."""
    return _build(index, p, max_chunk, rank_ops.occ)


def build_prefix_lut_plain(
    index: DeviceIndex, p: int, max_chunk: int = 1 << 22
) -> torch.Tensor:
    """Plain torch form of :func:`build_prefix_lut` (no kernel on any
    device), the reference K1's LUT is checked against on the card."""
    return _build(index, p, max_chunk, _occ_plain)


def _build(index: DeviceIndex, p: int, max_chunk: int, occ) -> torch.Tensor:
    """The level BFS, with ``occ(index, c, i)`` as its rank.

    Levels above ``max_chunk`` entries extend in chunks, which bounds the
    temporaries of one extension.  Chunking is exact — each entry's
    extension depends only on that entry — but must slice PER PREPEND-CHAR c
    (the output is c-major), so each level-ℓ chunk [a:b) produces four
    output slices k·4^ℓ + [a:b), k = c-1."""
    if not (1 <= p <= 15):
        raise ValueError("prefix LUT order must be in [1, 15]")
    if max_chunk < 1:
        raise ValueError("max_chunk must be >= 1")
    l = index.C[1:5]
    u = index.C[2:6]
    size = 4
    for _ in range(p - 1):
        if size <= max_chunk:
            l, u = _extend_level(index, l, u, occ)
        else:
            parts = [[] for _ in range(8)]  # 4 c-blocks × (l, u)
            for a in range(0, size, max_chunk):
                b = min(a + max_chunk, size)
                cl, cu = _extend_level(index, l[a:b], u[a:b], occ)
                for k in range(4):
                    parts[2 * k].append(cl[k * (b - a) : (k + 1) * (b - a)])
                    parts[2 * k + 1].append(
                        cu[k * (b - a) : (k + 1) * (b - a)]
                    )
            l = torch.cat([c for k in range(4) for c in parts[2 * k]])
            u = torch.cat([c for k in range(4) for c in parts[2 * k + 1]])
        size *= 4
    l, u = canonical_empty(l, u)  # absent p-mers: (0, 0), like every path
    return torch.stack([l, u], dim=1).contiguous()


def default_lut_order(n: int, max_order: int = 12) -> int:
    """Pick p so the LUT is populated but not wasteful: ~log4(n) - 1,
    clamped to [4, max_order].  The cap of 12 is the JAX package's, kept so
    both engines pick the same p; tuning it for the H100 is open work."""
    if n <= 0:
        return 4
    logn = int(np.log2(max(n, 2)) / 2)
    return int(np.clip(logn - 1, 4, max_order))
