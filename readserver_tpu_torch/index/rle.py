"""RLE-BWT interchange codec (SGA RLUnit convention).

The reference stores its BWT run-length encoded: one byte per run, 3 bits
symbol / 5 bits length, max run 31 (SURVEY.md §2.1 "RLE-BWT storage
format").  The device index decodes to bit-packed planes at build time
(BASELINE.json: "RLE-BWT storage → packed arrays"), but the RLE form is
kept as an artifact/interchange format so corpora indexed by
reference-stack tools can be imported and re-exported.

Byte layout per run: ``symbol = byte & 0b111``, ``length = byte >> 3``
(1..31).  Symbol codes are this package's: $=0 A=1 C=2 G=3 T=4.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MAX_RUN = 31
MAGIC = "readserver-tpu-rlebwt-v1"


def encode_rle(bwt: np.ndarray) -> np.ndarray:
    """BWT symbol codes uint8[n] → RLE bytes uint8[r]."""
    bwt = np.asarray(bwt, dtype=np.uint8)
    n = len(bwt)
    if n == 0:
        return np.zeros(0, dtype=np.uint8)
    if bwt.max() > 7:
        raise ValueError("symbol codes must fit 3 bits")
    # run starts, then split runs longer than MAX_RUN
    change = np.flatnonzero(np.diff(bwt)) + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [n]]))
    syms = bwt[starts]
    # expand long runs
    reps = -(-lens // MAX_RUN)
    out_syms = np.repeat(syms, reps)
    out_lens = np.full(int(reps.sum()), MAX_RUN, dtype=np.int64)
    # fix the last piece of each run
    ends = np.cumsum(reps) - 1
    out_lens[ends] = lens - (reps - 1) * MAX_RUN
    return (out_syms | (out_lens << 3).astype(np.uint8)).astype(np.uint8)


def decode_rle(runs: np.ndarray) -> np.ndarray:
    """RLE bytes → BWT symbol codes uint8[n]."""
    runs = np.asarray(runs, dtype=np.uint8)
    syms = runs & 0b111
    lens = (runs >> 3).astype(np.int64)
    if runs.size and lens.min() < 1:
        raise ValueError("zero-length run in RLE stream")
    return np.repeat(syms, lens).astype(np.uint8)


def write_rle_bwt(path: str | Path, bwt: np.ndarray, num_reads: int) -> None:
    """Write an RLE-BWT file: JSON header line + raw run bytes.

    (The reference's binary header carries num_strings/num_symbols,
    SURVEY.md §3.1; same fields here, in a self-describing form.)
    """
    runs = encode_rle(bwt)
    header = json.dumps(
        {
            "magic": MAGIC,
            "num_strings": int(num_reads),
            "num_symbols": int(len(bwt)),
            "num_runs": int(len(runs)),
        }
    )
    with open(path, "wb") as fh:
        fh.write(header.encode() + b"\n")
        fh.write(runs.tobytes())


def read_rle_bwt(path: str | Path) -> tuple[np.ndarray, int]:
    """→ (bwt codes uint8[n], num_reads)."""
    with open(path, "rb") as fh:
        header = json.loads(fh.readline())
        if header.get("magic") != MAGIC:
            raise ValueError("not a readserver-tpu RLE-BWT file")
        runs = np.frombuffer(fh.read(), dtype=np.uint8)
    if len(runs) != header["num_runs"]:
        raise ValueError("truncated RLE stream")
    bwt = decode_rle(runs)
    if len(bwt) != header["num_symbols"]:
        raise ValueError("RLE stream length mismatch")
    return bwt, header["num_strings"]
