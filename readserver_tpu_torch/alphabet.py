"""Alphabet for the read index: $ A C G T.

The reference stack (SGA / ropebwt2; SURVEY.md §2.1 "RLE-BWT storage format")
uses a 5-symbol alphabet with ``$`` sorting before the four bases and one
distinct sentinel per read.  We keep the same collapsed symbol codes:

    0 = $   (read terminator; one per read, all sentinels collapse to code 0)
    1 = A   2 = C   3 = G   4 = T

Reads containing ``N`` (or any non-ACGT letter) are handled upstream by the
corpus normalizer (split/drop), matching the reference's preprocessing
(SURVEY.md §2.1 "Read preprocessing").
"""

from __future__ import annotations

import numpy as np

SENTINEL = 0
NUM_SYMBOLS = 5  # $ A C G T
BASES = "ACGT"

# byte → code; 0 for anything that is not ACGTacgt (callers must pre-filter)
_ENCODE_LUT = np.zeros(256, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _ENCODE_LUT[ord(_b)] = _i + 1
    _ENCODE_LUT[ord(_b.lower())] = _i + 1

_DECODE_LUT = np.frombuffer(b"$ACGT", dtype=np.uint8)

_COMPLEMENT = np.array([0, 4, 3, 2, 1], dtype=np.uint8)  # $->$ A<->T C<->G


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence → uint8 codes in {1..4}. Raises on non-ACGT letters."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _ENCODE_LUT[raw]
    if codes.size and not codes.all():
        bad = chr(raw[np.argmin(codes)])
        raise ValueError(f"non-ACGT character {bad!r} in sequence")
    return codes


def decode(codes: np.ndarray) -> str:
    """uint8 codes → ASCII string ('$' for sentinel code 0)."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (sentinels map to themselves)."""
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]


def is_valid_dna(seq: str | bytes) -> bool:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return bool(_ENCODE_LUT[raw].all()) if raw.size else True


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (1..4) into 2 bits/base in uint8 (A=0..T=3), LSB first.

    Used for the host-side cold corpus store (the analog of the reference's
    raw read storage; sentinels are not representable — store lengths
    separately).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    if codes.size and (codes.min() < 1 or codes.max() > 4):
        raise ValueError("pack_2bit expects base codes in 1..4")
    b = codes - 1
    pad = (-b.size) % 4
    if pad:
        b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
    b = b.reshape(-1, 4)
    return (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(
        np.uint8
    )


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_2bit`; returns ``n`` base codes in 1..4."""
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.empty((packed.size, 4), dtype=np.uint8)
    out[:, 0] = packed & 3
    out[:, 1] = (packed >> 2) & 3
    out[:, 2] = (packed >> 4) & 3
    out[:, 3] = (packed >> 6) & 3
    return out.reshape(-1)[:n] + 1
