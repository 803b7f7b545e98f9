"""Batched occ/rank on the fused rank-block layout.

``occ(c, i)`` = # of symbol ``c`` in ``BWT[0:i]`` (exclusive): one row of the
rank table holds ``[checkpoint, plane words...]`` and the in-block remainder
is a masked popcount over the plane words.

Two forms of one function:

* :func:`occ_rows_plain`, plain torch, a port of the JAX package's
  ``ops/rank.py::occ_rows``.  torch has no uint32 shifts on the CPU and no
  popcount op, so the words are widened to int64, masked with
  ``& 0xFFFFFFFF``, and counted with a SWAR popcount.
* kernel K1 (``csrc/rank.cu``), one thread per rank.

:func:`occ_rows` takes the plain form for CPU tensors and launches K1 for
CUDA tensors (there is no fallback between them).
"""

from __future__ import annotations

import torch

from readserver_tpu_torch.kernels import RANK_OCC
from readserver_tpu_torch.kernels.build import on_cuda, ptr
from readserver_tpu_torch.ops.types import DeviceIndex

_WORD = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding 32-bit words (0 ≤ x < 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _inblock_count(
    rows: torch.Tensor, within: torch.Tensor, words_per_block: int
) -> torch.Tensor:
    """rows int32 [B, row_words] (uint32 bits), within [B] → masked popcount
    int32 [B] over the first ``within`` bits of the block's bitplane (words
    at columns 1..W, LSB-first within each word)."""
    words = rows[:, 1 : 1 + words_per_block].to(torch.int64) & _WORD
    word_base = torch.arange(
        words_per_block, dtype=torch.int64, device=rows.device
    ) * 32
    bits = (within.to(torch.int64)[:, None] - word_base[None, :]).clamp(0, 32)
    # (1 << 32) is undefined for uint32 — build the full-word mask via where
    partial = (torch.ones_like(bits) << bits.clamp(max=31)) - 1
    mask = torch.where(bits >= 32, torch.full_like(bits, _WORD), partial)
    return popcount32(words & mask).sum(dim=1).to(torch.int32)


def occ_rows_plain(
    rank_rows: torch.Tensor,
    c: torch.Tensor,
    i: torch.Tensor,
    *,
    rows_per_symbol: int,
    log2_block: int,
    words_per_block: int,
) -> torch.Tensor:
    """Plain torch rank against an explicit row table, on any device.

    c int32 [B] in 0..P-1, i int32 [B] in [0, n] → occ int32 [B].  The flat
    row index is int64 (a triple table's word offset passes 2^31 at chr20
    scale)."""
    block = i >> log2_block
    within = i - (block << log2_block)
    flat = c.to(torch.int64) * rows_per_symbol + block.to(torch.int64)
    rows = rank_rows.index_select(0, flat)
    base = rows[:, 0]  # checkpoints < 2**31 by build
    return base + _inblock_count(rows, within, words_per_block)


def occ_rows_cuda(
    rank_rows: torch.Tensor,
    c: torch.Tensor,
    i: torch.Tensor,
    *,
    rows_per_symbol: int,
    log2_block: int,
    words_per_block: int,
) -> torch.Tensor:
    """Launch K1 on CUDA tensors (the arguments of :func:`occ_rows_plain`)."""
    _check_table(rank_rows)
    for name, t in (("c", c), ("i", i)):
        if t.device != rank_rows.device or t.dtype != torch.int32:
            raise ValueError(
                f"{name} must be int32 on {rank_rows.device}, got "
                f"{t.dtype} on {t.device}"
            )
        if t.dim() != 1 or t.shape != c.shape:
            raise ValueError(f"c and i must be matching 1-D, got {tuple(t.shape)}")
    c = c.contiguous()
    i = i.contiguous()
    out = torch.empty_like(i)
    B = i.shape[0]
    if B:
        RANK_OCC(
            ptr(rank_rows), ptr(c), ptr(i), ptr(out), B, rows_per_symbol,
            log2_block, words_per_block, rank_rows.shape[1],
        )
    return out


def _check_table(t: torch.Tensor) -> None:
    """A rank-row table the kernels can read: int32 (uint32 bits), 2-D,
    contiguous, on a CUDA device, rows 16-byte aligned for the vector
    load when ``row_words == 4``."""
    if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2:
        raise ValueError(
            f"rank table must be a 2-D int32 CUDA tensor, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError("rank table must be contiguous")
    if t.shape[1] == 4 and t.data_ptr() % 16:
        raise ValueError("rank table must be 16-byte aligned")


def occ_rows(
    rank_rows: torch.Tensor,
    c: torch.Tensor,
    i: torch.Tensor,
    *,
    rows_per_symbol: int,
    log2_block: int,
    words_per_block: int,
) -> torch.Tensor:
    """Batched rank against an explicit row table: K1 for CUDA tensors,
    the plain form for CPU tensors.

    c int32 [B] in 0..P-1, i int32 [B] in [0, n] → occ int32 [B].
    """
    fn = occ_rows_cuda if on_cuda(rank_rows) else occ_rows_plain
    return fn(
        rank_rows, c, i, rows_per_symbol=rows_per_symbol,
        log2_block=log2_block, words_per_block=words_per_block,
    )


def occ(index: DeviceIndex, c: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """# of symbol ``c`` in ``BWT[0:i]``; both arguments int32 [B]."""
    return occ_rows(
        index.rank_rows,
        c,
        i,
        rows_per_symbol=index.rows_per_symbol,
        log2_block=index.log2_block,
        words_per_block=index.words_per_block,
    )
