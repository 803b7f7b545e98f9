"""Batched backward search (the hot path).

Each query's interval starts from its last character (``l0 = C[c]``,
``u0 = C[c+1]``, no rank needed) or from a prefix LUT row covering its last
p characters, then moves left through the half-open update

    l' = C[c] + occ(c, l);   u' = C[c] + occ(c, u)

one character per step (``backward_search``, ``backward_search_lut``) or
three and two characters per step over the triple and pair plane tables
(``backward_search_pair``).  Empty intervals come out as the canonical
``(0, 0)`` on every path, so every path gives the same bits.

Each search has two forms: a plain torch form (``*_plain``), a port of the
JAX package's ``ops/search.py`` that advances the whole batch one step at a
time, and kernel K2 (``csrc/search.cu``), which carries each query through
all of its steps in one thread.  The public functions take the plain form
for CPU tensors and launch K2 for CUDA tensors; both refuse a code outside
1..4 in a searched column with ``ValueError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.kernels import BACKWARD_SEARCH
from readserver_tpu_torch.kernels.build import on_cuda, ptr
from readserver_tpu_torch.ops.rank import _check_table, occ_rows_plain
from readserver_tpu_torch.ops.types import DeviceIndex


def encode_query_batch(
    kmers: Sequence[np.ndarray | str | bytes], max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """k-mers → (codes int32 [B, max_len] RIGHT-aligned 0-padded, lengths).

    Right alignment puts every query's final character in the last column,
    which the C-init and prefix-LUT fast paths rely on.
    """
    B = len(kmers)
    out = np.zeros((B, max_len), dtype=np.int32)
    if B and all(isinstance(k, (str, bytes)) for k in kmers):
        # vectorized: one join, one LUT gather, one flat scatter
        lengths64 = np.fromiter(
            (len(k) for k in kmers), dtype=np.int64, count=B
        )
        if lengths64.min() < 1 or lengths64.max() > max_len:
            bad = int(
                np.flatnonzero((lengths64 < 1) | (lengths64 > max_len))[0]
            )
            raise ValueError(
                f"query length {lengths64[bad]} outside [1, {max_len}]"
            )
        joined = b"".join(
            k.encode("ascii") if isinstance(k, str) else bytes(k)
            for k in kmers
        )
        raw = np.frombuffer(joined, dtype=np.uint8)
        codes = alphabet._ENCODE_LUT[raw]
        if codes.size and not codes.all():
            bad = chr(raw[int(np.argmin(codes))])
            raise ValueError(f"non-ACGT character {bad!r} in sequence")
        # right-aligned flat scatter: query b's chars land at row b,
        # columns [max_len - L_b, max_len)
        starts = np.repeat(
            max_len * np.arange(B, dtype=np.int64) + (max_len - lengths64),
            lengths64,
        )
        cum = np.cumsum(lengths64) - lengths64
        offs = np.arange(len(raw), dtype=np.int64) - np.repeat(cum, lengths64)
        out.reshape(-1)[starts + offs] = codes
        return out, lengths64.astype(np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for b, km in enumerate(kmers):
        codes = km if isinstance(km, np.ndarray) else alphabet.encode(km)
        L = len(codes)
        if L == 0 or L > max_len:
            raise ValueError(f"query length {L} outside [1, {max_len}]")
        out[b, max_len - L :] = codes
        lengths[b] = L
    return out, lengths


def canonical_empty(
    l: torch.Tensor, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize empty intervals to ``(0, 0)``: an empty interval's frozen
    bounds depend on step granularity, so every search output passes
    through this to make bounds comparable for ALL queries."""
    empty = l >= u
    zero = torch.zeros_like(l)
    return torch.where(empty, zero, l), torch.where(empty, zero, u)


def prefix_ids(kmers: torch.Tensor, p: int) -> torch.Tensor:
    """int32 [B]: id of each query's last-p-character suffix (first char
    most significant).  Valid only for queries with length ≥ p."""
    K = kmers.shape[1]
    tail = kmers[:, K - p :].to(torch.int64)
    weights = 4 ** torch.arange(
        p - 1, -1, -1, dtype=torch.int64, device=kmers.device
    )
    return ((tail - 1) * weights[None, :]).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------- plain forms


def _layout(index: DeviceIndex) -> dict:
    return dict(
        rows_per_symbol=index.rows_per_symbol,
        log2_block=index.log2_block,
        words_per_block=index.words_per_block,
    )


def _step_plain(index, table, starts, code, l, u, active):
    """One batch step over ``table``: both ranks in one [2B] gather."""
    B = l.shape[0]
    occ2 = occ_rows_plain(
        table, torch.cat([code, code]), torch.cat([l, u]), **_layout(index)
    )
    base = starts.index_select(0, code.to(torch.int64))
    return (
        torch.where(active, base + occ2[:B], l),
        torch.where(active, base + occ2[B:], u),
    )


def _lut_start(lut, p, kmers):
    rows = lut.index_select(0, prefix_ids(kmers, p).to(torch.int64))
    return rows[:, 0], rows[:, 1]


def _c_start(index, kmers):
    c_last = kmers[:, -1].to(torch.int64)
    return index.C.index_select(0, c_last), index.C.index_select(0, c_last + 1)


def _scan_steps_plain(index, kmers, lengths, l, u, last_col: int):
    """Masked lockstep steps over columns last_col-1 .. 0."""
    K = kmers.shape[1]
    first = K - lengths
    for j in range(last_col - 1, -1, -1):
        active = (j >= first) & (l < u)
        l, u = _step_plain(
            index, index.rank_rows, index.C, kmers[:, j], l, u, active
        )
    return l, u


def backward_search_plain(index, kmers, lengths):
    """Plain torch form of :func:`backward_search`."""
    l, u = _c_start(index, kmers)
    l, u = _scan_steps_plain(index, kmers, lengths, l, u, kmers.shape[1] - 1)
    return canonical_empty(l, u)


def backward_search_lut_plain(index, lut, p, kmers, lengths):
    """Plain torch form of :func:`backward_search_lut`."""
    l, u = _lut_start(lut, p, kmers)
    l, u = _scan_steps_plain(index, kmers, lengths, l, u, kmers.shape[1] - p)
    return canonical_empty(l, u)


def backward_search_pair_plain(index, kmers, lut=None, p: int = 0):
    """Plain torch form of :func:`backward_search_pair`: greedy triples,
    then pairs, then one single step at the left edge."""
    K = kmers.shape[1]
    if index.rank2_rows is None:
        raise ValueError("index was built without the pair-rank tier")
    if lut is not None and p:
        l, u = _lut_start(lut, p, kmers)
        r = K - p
    else:
        l, u = _c_start(index, kmers)
        r = K - 1
    ntriples = r // 3 if index.rank3_rows is not None else 0
    rem = r - 3 * ntriples
    # leftover columns sit at the LEFT (the pattern's first characters)
    # and run last
    for j in range(r - 3, rem - 1, -3):
        code = (
            (kmers[:, j] - 1) * 16 + (kmers[:, j + 1] - 1) * 4
            + (kmers[:, j + 2] - 1)
        )
        l, u = _step_plain(index, index.rank3_rows, index.C3, code, l, u, l < u)
    for j in range(rem - 2, rem % 2 - 1, -2):
        code = (kmers[:, j] - 1) * 4 + (kmers[:, j + 1] - 1)
        l, u = _step_plain(index, index.rank2_rows, index.C2, code, l, u, l < u)
    if rem % 2:
        l, u = _step_plain(
            index, index.rank_rows, index.C, kmers[:, 0], l, u, l < u
        )
    return canonical_empty(l, u)


# ------------------------------------------------------------- input guard


def _bad_message(nbad: int, K: int) -> str:
    return (
        f"{nbad} queries hold a code outside 1..4 in a searched column, or "
        f"a length outside [1, {K}]"
    )


def _check_codes(kmers, lengths, p: int) -> None:
    """Raise ``ValueError`` for the inputs K2 refuses: a code outside 1..4
    in any column the search reads (every column for the k-step search;
    the last ``max(length, p)`` columns otherwise), or a length outside
    [1, K].  The CPU form of the guard in ``csrc/search.cu``."""
    B, K = kmers.shape
    bad_code = (kmers < 1) | (kmers > 4)
    if lengths is None:
        bad = bad_code.any(dim=1)
    else:
        first = (K - lengths.to(torch.int64)).clamp(max=K - p)
        cols = torch.arange(K, device=kmers.device)
        read = cols[None, :] >= first[:, None]
        bad = (lengths < 1) | (lengths > K) | (bad_code & read).any(dim=1)
    nbad = int(bad.sum())
    if nbad:
        raise ValueError(_bad_message(nbad, K))


# ----------------------------------------------------------------- kernel K2


def _check_int32(name: str, t: torch.Tensor, device, shape=None) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous int32 tensor on {device}, got "
            f"{t.dtype} on {t.device}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def backward_search_cuda(
    index: DeviceIndex,
    kmers: torch.Tensor,
    lengths: torch.Tensor | None = None,
    lut: torch.Tensor | None = None,
    p: int = 0,
    kstep: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA tensors.

    ``kstep=False``: the masked 1-step search (``lengths`` required), from
    the LUT when one is given.  ``kstep=True``: the k-step schedule of
    :func:`backward_search_pair` (every query of length K).  Raises
    ``ValueError`` on the inputs :func:`_check_codes` refuses, which costs
    one wait for the card per call."""
    dev = index.device
    _check_int32("kmers", kmers, dev)
    if kmers.dim() != 2 or kmers.shape[1] < 1:
        raise ValueError(f"kmers must be [B, K], got {tuple(kmers.shape)}")
    B, K = kmers.shape
    _check_table(index.rank_rows)
    _check_int32("C", index.C, dev, (6,))
    if kstep:
        if index.rank2_rows is None:
            raise ValueError("index was built without the pair-rank tier")
        _check_table(index.rank2_rows)
        _check_int32("C2", index.C2, dev, (16,))
        if index.rank3_rows is not None:
            _check_table(index.rank3_rows)
            _check_int32("C3", index.C3, dev, (64,))
        lengths = None
    else:
        if lengths is None:
            raise ValueError("the masked search needs per-query lengths")
        _check_int32("lengths", lengths, dev, (B,))
    if lut is not None and p:
        if not 1 <= p <= K:
            raise ValueError(f"LUT order {p} outside [1, K={K}]")
        _check_int32("lut", lut, dev, (4**p, 2))
    else:
        lut, p = None, 0
    l = torch.empty(B, dtype=torch.int32, device=dev)
    u = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
        r3 = index.rank3_rows if kstep else None
        BACKWARD_SEARCH(
            ptr(kmers), ptr(lengths), B, K, ptr(index.C),
            ptr(index.rank_rows), ptr(lut), p,
            ptr(index.rank2_rows if kstep else None),
            ptr(index.C2 if kstep else None),
            ptr(r3), ptr(index.C3 if r3 is not None else None), int(kstep),
            index.rows_per_symbol, index.log2_block, index.words_per_block,
            index.rank_rows.shape[1], ptr(l), ptr(u), ptr(bad),
        )
        nbad = int(bad.item())
        if nbad:
            raise ValueError(_bad_message(nbad, K))
    return l, u


# ------------------------------------------------------------------- public


def backward_search(
    index: DeviceIndex,
    kmers: torch.Tensor,     # int32 [B, K], codes 1..4 RIGHT-aligned, 0 pad
    lengths: torch.Tensor,   # int32 [B], all >= 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ half-open interval ``(l, u)`` per query, int32 [B] each; empty
    intervals come out as the canonical ``(0, 0)``."""
    if on_cuda(index.rank_rows):
        return backward_search_cuda(index, kmers, lengths)
    _check_codes(kmers, lengths, 0)
    return backward_search_plain(index, kmers, lengths)


def backward_search_lut(
    index: DeviceIndex,
    lut: torch.Tensor,       # int32 [4^p, 2] p-mer intervals (ops/lut.py)
    p: int,
    kmers: torch.Tensor,     # int32 [B, K] right-aligned; ALL lengths >= p
    lengths: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LUT-started search: the first p steps are one LUT row."""
    if on_cuda(index.rank_rows):
        return backward_search_cuda(index, kmers, lengths, lut=lut, p=p)
    _check_codes(kmers, lengths, p)
    return backward_search_lut_plain(index, lut, p, kmers, lengths)


def backward_search_pair(
    index: DeviceIndex,
    kmers: torch.Tensor,     # int32 [B, K]; EVERY query must have length K
    lut: torch.Tensor | None = None,
    p: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-step backward search: one rank over the triple (``rank3_rows``/
    ``C3``) or pair (``rank2_rows``/``C2``) planes advances three or two
    characters, landing exactly where single steps would.

    Restricted to uniform full-width batches (every query length == K); the
    engine routes mixed-length batches to the masked 1-step path.  Bit-
    identical to :func:`backward_search`, empties included."""
    if on_cuda(index.rank_rows):
        return backward_search_cuda(index, kmers, lut=lut, p=p, kstep=True)
    _check_codes(kmers, None, 0)
    return backward_search_pair_plain(index, kmers, lut, p)
