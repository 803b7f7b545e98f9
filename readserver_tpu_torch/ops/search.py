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
for CPU tensors and launch K2 for CUDA tensors, through
:func:`search_batch`; both refuse a code outside 1..4 in a searched column
with ``ValueError``.  The engine calls :func:`search_batch` with a device
counter instead, into which K2 counts refused queries, so that no search
waits for the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from readserver_tpu_torch import alphabet
from readserver_tpu_torch.kernels import BACKWARD_SEARCH
from readserver_tpu_torch.kernels.build import check_int32, on_cuda, ptr
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


def kstep_schedule(last_col: int, kstep: int) -> list[tuple[int, int]]:
    """The k-step schedule over columns ``[0, last_col)``: ``(j, k)``, a
    step over columns ``j .. j + k - 1``, in the order taken.  Triples
    from the right (``kstep`` 3), then pairs, then one single step at
    column 0 where one column is left: the leftover columns sit at the
    left (the pattern's first characters) and run last.  K2 and the
    sharded search take the same schedule (``csrc/search.cuh``)."""
    ntriples = last_col // 3 if kstep >= 3 else 0
    rem = last_col - 3 * ntriples
    return ([(j, 3) for j in range(last_col - 3, rem - 1, -3)]
            + [(j, 2) for j in range(rem - 2, rem % 2 - 1, -2)]
            + ([(0, 1)] if rem % 2 else []))


def step_code(kmers: torch.Tensor, j: int, k: int) -> torch.Tensor:
    """The plane a step of ``k`` columns from column ``j`` ranks: for
    k = 1 the code itself (1..4, a base plane), else the columns' codes
    less 1 in base 4, the first column most significant."""
    if k == 1:
        return kmers[:, j]
    code = kmers[:, j] - 1
    for t in range(1, k):
        code = code * 4 + (kmers[:, j + t] - 1)
    return code


def run_kstep(kmers, l, u, last_col: int, kstep: int, step,
              early_exit: bool = False):
    """The k-step schedule (:func:`kstep_schedule`) from the intervals
    ``(l, u)``: each step is ``(l, u) = step(k, code, l, u, l < u)``, the
    rank function of the caller's index (``step`` leaves inactive lanes
    as they are).  ``early_exit`` stops once every interval is empty,
    which changes no answer."""
    for j, k in kstep_schedule(last_col, kstep):
        if early_exit and not bool((l < u).any()):
            break
        l, u = step(k, step_code(kmers, j, k), l, u, l < u)
    return l, u


def backward_search_pair_plain(index, kmers, lut=None, p: int = 0):
    """Plain torch form of :func:`backward_search_pair`: the k-step
    schedule over the triple (where the index has it) and pair tables."""
    K = kmers.shape[1]
    if index.rank2_rows is None:
        raise ValueError("index was built without the pair-rank tier")
    if lut is not None and p:
        l, u = _lut_start(lut, p, kmers)
        r = K - p
    else:
        l, u = _c_start(index, kmers)
        r = K - 1
    tables = {3: (index.rank3_rows, index.C3), 2: (index.rank2_rows, index.C2),
              1: (index.rank_rows, index.C)}

    def step(k, code, l, u, active):
        return _step_plain(index, *tables[k], code, l, u, active)

    kstep = 3 if index.rank3_rows is not None else 2
    return canonical_empty(*run_kstep(kmers, l, u, r, kstep, step))


# ------------------------------------------------------------- input guard


def _bad_message(nbad: int, K: int) -> str:
    return (
        f"{nbad} queries hold a code outside 1..4 in a searched column, or "
        f"a length outside [1, {K}]"
    )


def _refused(kmers, lengths, p: int) -> torch.Tensor:
    """bool [B]: the queries K2 refuses: a code outside 1..4 in any column
    the search reads (every column for the k-step search, ``lengths`` None;
    the last ``max(length, p)`` columns otherwise), or a length outside
    [1, K].  The plain form of the guard in ``csrc/search.cu``."""
    B, K = kmers.shape
    bad_code = (kmers < 1) | (kmers > 4)
    if lengths is None:
        return bad_code.any(dim=1)
    first = (K - lengths.to(torch.int64)).clamp(max=K - p)
    cols = torch.arange(K, device=kmers.device)
    read = cols[None, :] >= first[:, None]
    return (lengths < 1) | (lengths > K) | (bad_code & read).any(dim=1)


def raise_if_refused(nbad: int, K: int) -> None:
    """Raise ``ValueError`` when a search counted ``nbad`` refused queries
    (the check a caller of :func:`search_batch` makes on its count)."""
    if nbad:
        raise ValueError(_bad_message(nbad, K))


# ----------------------------------------------------------------- kernel K2


SEARCH_MAX_K = 256  # columns K2 packs in a thread's registers


def backward_search_cuda(
    index: DeviceIndex,
    kmers: torch.Tensor,
    lengths: torch.Tensor | None = None,
    lut: torch.Tensor | None = None,
    p: int = 0,
    kstep: bool = False,
    *,
    bad: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA tensors.

    ``kstep=False``: the masked 1-step search (``lengths`` required), from
    the LUT when one is given.  ``kstep=True``: the k-step schedule of
    :func:`backward_search_pair` (every query of length K).  ``kmers`` may
    be a view at any offset of its storage; K is at most
    ``SEARCH_MAX_K``.

    A refused query (:func:`_refused`) reads no table and comes out
    ``(0, 0)``; K2 counts it.  With ``bad`` (int32 [1] on the card) the
    count is added there and the call returns without waiting for the card;
    the caller checks it (the engine does, with its one result copy).
    Without ``bad`` the wrapper reads the count back, which waits, and
    raises ``ValueError``."""
    dev = index.device
    check_int32("kmers", kmers, dev)
    if kmers.dim() != 2 or kmers.shape[1] < 1:
        raise ValueError(f"kmers must be [B, K], got {tuple(kmers.shape)}")
    B, K = kmers.shape
    if K > SEARCH_MAX_K:
        raise ValueError(
            f"K2 searches at most {SEARCH_MAX_K} columns, got K={K}"
        )
    _check_table(index.rank_rows)
    check_int32("C", index.C, dev, (6,))
    if kstep:
        if index.rank2_rows is None:
            raise ValueError("index was built without the pair-rank tier")
        _check_table(index.rank2_rows)
        check_int32("C2", index.C2, dev, (16,))
        if index.rank3_rows is not None:
            _check_table(index.rank3_rows)
            check_int32("C3", index.C3, dev, (64,))
        lengths = None
    else:
        if lengths is None:
            raise ValueError("the masked search needs per-query lengths")
        check_int32("lengths", lengths, dev, (B,))
    if lut is not None and p:
        if not 1 <= p <= K:
            raise ValueError(f"LUT order {p} outside [1, K={K}]")
        check_int32("lut", lut, dev, (4**p, 2))
    else:
        lut, p = None, 0
    wait = bad is None
    if wait:
        bad = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        check_int32("bad", bad, dev, (1,))
    l = torch.empty(B, dtype=torch.int32, device=dev)
    u = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        r3 = index.rank3_rows if kstep else None
        BACKWARD_SEARCH(
            ptr(kmers), ptr(lengths), B, K, ptr(index.C),
            ptr(index.rank_rows), ptr(lut), p,
            ptr(index.rank2_rows if kstep else None),
            ptr(index.C2 if kstep else None),
            ptr(r3), ptr(index.C3 if r3 is not None else None), int(kstep),
            index.rows_per_symbol, index.log2_block, index.words_per_block,
            index.rank_rows.shape[1], ptr(l), ptr(u), ptr(bad), device=dev,
        )
        if wait:
            raise_if_refused(int(bad.item()), K)
    return l, u


def search_batch(
    index: DeviceIndex,
    kmers: torch.Tensor,
    lengths: torch.Tensor | None,
    lut: torch.Tensor | None,
    p: int,
    kstep: bool,
    bad: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The search behind the public functions and the engine: the k-step
    schedule (``kstep``) or the masked 1-step search, from the LUT when one
    is given.

    CUDA tensors launch K2 (:func:`backward_search_cuda`): with ``bad``
    (int32 [1] on the card) the refused queries are counted there and the
    call does not wait, the caller checks the count with
    :func:`raise_if_refused`; without it the call waits and raises
    ``ValueError``.  CPU tensors run the plain forms and raise
    ``ValueError`` on a refused query at once (there is no card to wait
    for, and ``bad`` is left as it is)."""
    if lut is None or not p:
        lut, p = None, 0
    if on_cuda(index.rank_rows):
        return backward_search_cuda(
            index, kmers, lengths, lut, p, kstep, bad=bad
        )
    if kstep:
        lengths = None
    raise_if_refused(int(_refused(kmers, lengths, p).sum()), kmers.shape[1])
    if kstep:
        return backward_search_pair_plain(index, kmers, lut, p)
    if p:
        return backward_search_lut_plain(index, lut, p, kmers, lengths)
    return backward_search_plain(index, kmers, lengths)


# ------------------------------------------------------------------- public


def backward_search(
    index: DeviceIndex,
    kmers: torch.Tensor,     # int32 [B, K], codes 1..4 RIGHT-aligned, 0 pad
    lengths: torch.Tensor,   # int32 [B], all >= 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ half-open interval ``(l, u)`` per query, int32 [B] each; empty
    intervals come out as the canonical ``(0, 0)``."""
    return search_batch(index, kmers, lengths, None, 0, False)


def backward_search_lut(
    index: DeviceIndex,
    lut: torch.Tensor,       # int32 [4^p, 2] p-mer intervals (ops/lut.py)
    p: int,
    kmers: torch.Tensor,     # int32 [B, K] right-aligned; ALL lengths >= p
    lengths: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LUT-started search: the first p steps are one LUT row."""
    return search_batch(index, kmers, lengths, lut, p, False)


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
    return search_batch(index, kmers, None, lut, p, True)
